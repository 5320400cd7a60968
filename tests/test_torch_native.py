"""The port's native host runtime (crdt_tpu_torch.native, its own
ingest.cpp built by g++ at first use) against the JAX package's native
runtime and the pure-Python path, zero tolerance; follows
tests/test_native.py case by case."""
import numpy as np
import pytest

from crdt_tpu import native as jnative
from crdt_tpu.utils import intern as jintern
from crdt_tpu_torch import native
from crdt_tpu_torch.models import oplog
from crdt_tpu_torch.utils import intern as py_intern
from tests.native_build import require_jax_native

COLS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")
WORDS = (["a", "bb", "a", "", "ccc", "bb", "é", "a" * 1000, 'q"uote', "back\\slash",
          "ctl\x01\x1f", "\n\t", "λ∀🎉"] + [f"k{i}" for i in range(3000)])


def test_interner_matches_python_and_jax():
    """Ids, sizes and lookups equal the Python interner's and the JAX
    native interner's, through the table's growth and on adversarial
    strings (control characters, quotes, backslashes, non-ASCII, empty)."""
    require_jax_native()
    ni, pi, ji = native.NativeInterner(), py_intern.Interner(), jnative.NativeInterner()
    for w in WORDS:
        assert ni.intern(w) == pi.intern(w) == ji.intern(w), w
    assert len(ni) == len(pi) == len(ji)
    for i in range(len(pi)):
        assert ni.lookup(i) == pi.lookup(i) == ji.lookup(i)
    with pytest.raises(IndexError):
        ni.lookup(len(pi))


def test_parse_go_int_matches_python_and_jax():
    require_jax_native()
    cases = ["42", "-13", "+7", "007", "", " 1", "1 ", "1_0", "0x10", "1.5",
             "abc", "--1", "+", "2147483647", "2147483648", "-2147483648",
             "-2147483649", "0", "-0", "99999999999999999999", "٣"]
    for s in cases:
        assert native.parse_go_int(s) == py_intern.parse_go_int(s) \
            == jnative.parse_go_int(s) == jintern.parse_go_int(s), s


def test_batch_packer_matches_encode_value_and_jax():
    """take() gives the columns encode_value gives and the JAX packer's,
    and clears; the interned tables agree."""
    require_jax_native()
    sides = {"t": (native.NativeInterner(), native.NativeInterner()),
             "j": (jnative.NativeInterner(), jnative.NativeInterner())}
    packers = {"t": native.OpBatchPacker(*sides["t"]),
               "j": jnative.OpBatchPacker(*sides["j"])}
    keys_p, vals_p = py_intern.Interner(), py_intern.Interner()
    rng = np.random.default_rng(0)
    rows = [(10, 0, 0, "x", "5"), (11, 1, 0, "y", "hello"), (11, 1, 1, "x", "-20"),
            (12, 2, 0, "z", "007"), (13, 2, 1, 'k"\\', "\x00\n"), (14, 3, 0, "", "")]
    rows += [(int(rng.integers(0, 2**31 - 1)), int(rng.integers(-2, 8)), int(rng.integers(0, 99)),
              f"k{rng.integers(20)}", str(rng.integers(-30, 30)) if rng.random() < .5
              else f"s{rng.integers(9)}") for _ in range(200)]
    expect = {n: [] for n in COLS}
    for ts, rid, seq, k, v in rows:
        for p in packers.values():
            p.add(ts, rid, seq, k, v)
        val, payload, is_num = py_intern.encode_value(v, vals_p)
        for n, x in zip(COLS, (ts, rid, seq, keys_p.intern(k), val, payload, is_num)):
            expect[n].append(x)
    got = {n: p.take() for n, p in packers.items()}
    assert len(packers["t"]) == 0
    for name, exp in expect.items():
        assert got["t"][name].tolist() == got["j"][name].tolist() == exp, name
        assert got["t"][name].dtype == got["j"][name].dtype
    for t_int, j_int in zip(sides["t"], sides["j"]):
        assert [t_int.lookup(i) for i in range(len(t_int))] == \
            [j_int.lookup(i) for i in range(len(j_int))]
    assert [sides["t"][0].lookup(i) for i in range(len(keys_p))] == \
        [keys_p.lookup(i) for i in range(len(keys_p))]


def test_batch_feeds_oplog():
    keys, vals = native.NativeInterner(), native.NativeInterner()
    packer = native.OpBatchPacker(keys, vals)
    packer.add(1, 0, 0, "k", "5")
    packer.add(2, 0, 1, "k", "-3")
    log = oplog.from_ops(8, packer.take(), device="cpu")
    kv = oplog.rebuild(log, n_keys=len(keys))
    assert oplog.materialize(kv, keys, vals) == {"k": "2"}


def test_contains_does_not_mutate():
    ni = native.NativeInterner()
    ni.intern("present")
    assert "present" in ni
    assert "absent" not in ni
    assert len(ni) == 1  # probing must not intern


def test_concurrent_first_builds_each_load_a_whole_library(tmp_path):
    """Processes and threads that all build the library first at once (test
    workers, daemons started together) each end up loading a whole one:
    one compiles under the file lock, the rest wait and reuse it."""
    import subprocess
    import sys
    import threading
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys, threading; from pathlib import Path; import crdt_tpu_torch.native as n;"
            f"n.BUILD_DIR = Path({str(tmp_path)!r});"
            "errs = [];"
            "ts = [threading.Thread(target=lambda: errs.append(n.NativeInterner().intern('x')))"
            " for _ in range(4)];"
            "[t.start() for t in ts]; [t.join(120) for t in ts];"
            "assert errs == [0] * 4, errs; print(n.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).parent == tmp_path
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == \
        [native.library_path().name]
    assert not list(tmp_path.glob("*.tmp"))
