"""The hand-written CUDA lexn_union kernel against its plain PyTorch twin,
bit for bit.  Needs a card (marked ``cuda``; skips without one) and imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_hopper_kernel.py
"""
import numpy as np
import pytest
import torch

from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1


def _planes(rng, c, lanes, g, fraction):
    """(hi, lo, val, pay): each lane a seeded subset of a g-op pool, sorted
    per lane by (hi, lo), the first c rows kept, SENTINEL/0 padded."""
    ids = np.sort(rng.choice(10 * g, g, replace=False))
    pool = [(ids // 4).astype(np.int32), ids.astype(np.int32),
            rng.integers(-20, 20, g).astype(np.int32),
            (rng.integers(0, 1000, g) | (rng.integers(0, 2, g) << 31)).astype(np.int32)]
    planes = [np.full((c, lanes), S, np.int32), np.full((c, lanes), S, np.int32),
              np.zeros((c, lanes), np.int32), np.zeros((c, lanes), np.int32)]
    for j in range(lanes):
        rows = np.nonzero(rng.random(g) < fraction)[0][:c]
        for p in range(4):
            planes[p][: len(rows), j] = pool[p][rows]
    return planes


def _run(planes_a, planes_b, out_size, device):
    t = [torch.from_numpy(x).to(device) for x in planes_a + planes_b]
    keys, vals, nu = hu.sorted_union_columnar_fused_lexn(
        t[:2], t[2:4], t[4:6], t[6:], out_size=out_size)
    return [x.cpu() for x in (*keys, *vals, nu)]


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, g, out", [
    (8, 1, 16, 8), (8, 127, 16, 8), (8, 130, 16, None),
    (64, 130, 192, 64), (1024, 300, 2048, 1024),
])
def test_cuda_kernel_matches_plain_twin(c, lanes, g, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexn_union kernel has no CPU mode")
    rng = np.random.default_rng(c + lanes)
    a, b = _planes(rng, c, lanes, g, 0.5), _planes(rng, c, lanes, g, 0.5)
    before = hu.LAUNCHES["lexn_union"]
    got = _run(a, b, out, "cuda")
    torch.cuda.synchronize()
    assert hu.LAUNCHES["lexn_union"] == before + 1
    want = _run(a, b, out, "cpu")
    for w, k in zip(want, got):
        assert torch.equal(w, k)


@pytest.mark.cuda
def test_cuda_kernel_refuses_capacity_past_shared_memory():
    """C=8192 at (2, 2) needs ~400 KB of shared memory per block, past the
    card's opt-in limit: the launch is refused and the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexn_union kernel has no CPU mode")
    planes = [torch.full((8192, 2), S, dtype=torch.int32, device="cuda")] * 4
    before = hu.LAUNCHES["lexn_union"]
    with pytest.raises(RuntimeError, match="shared memory"):
        hu.sorted_union_columnar_fused_lexn(planes[:2], planes[2:], planes[:2], planes[2:])
    assert hu.LAUNCHES["lexn_union"] == before
