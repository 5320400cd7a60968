"""Every CUDA kernel of the port that runs as a thread-block cluster reaches
a cluster barrier before it writes into another CTA's shared memory.

A cluster's CTAs are all running only after a cluster barrier
(``cluster.sync()``); a CTA that stages rows through
``cluster.map_shared_rank`` before that may write into a CTA that has not
started, which faults now and then when two CTAs of a cluster share an SM.
The scan reads ``crdt_tpu_torch/csrc`` as text: for each ``__global__``
kernel that takes ``cg::this_cluster()``, the first ``cluster.sync()`` must
come before the first ``map_shared_rank`` in its body and before its first
call of a device helper that takes one (the staging helpers)."""
import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parent.parent / "crdt_tpu_torch" / "csrc"
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _strip_comments(text: str) -> str:
    """The source without comments and launch bounds (so a kernel's name is
    the first identifier before its parameter list)."""
    text = re.sub(r"/\*.*?\*/", lambda m: " " * len(m.group()), text, flags=re.S)
    text = re.sub(r"//[^\n]*", lambda m: " " * len(m.group()), text)
    return re.sub(r"__launch_bounds__\s*\([^)]*\)", "", text)


def _body(text: str, start: int) -> str:
    """The brace-balanced body of the function whose header starts at
    ``start``."""
    open_at = text.index("{", start)
    depth = 0
    for i in range(open_at, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[open_at:i + 1]
    raise AssertionError("unbalanced braces")


def _functions(text: str, qualifier: str):
    """(name, body) of every function declared with ``qualifier``."""
    for m in re.finditer(qualifier + r"\b[^;{(]*?\b(\w+)\s*\(", text):
        yield m.group(1), _body(text, m.end())


def _helpers(texts) -> set:
    """The device helpers that reach another CTA's shared memory."""
    return {name for text in texts for name, body in _functions(text, "__device__")
            if "map_shared_rank" in body}


def _cluster_kernels():
    texts = {p.name: _strip_comments(p.read_text()) for p in SOURCES}
    helpers = _helpers(texts.values())
    out = []
    for fname, text in texts.items():
        for name, body in _functions(text, "__global__"):
            if "this_cluster()" in body:
                out.append((f"{fname}:{name}", body, helpers))
    return out


KERNELS = _cluster_kernels()


def first_remote_write(body: str, helpers: set) -> int:
    """Offset of the body's first reach into the cluster's shared memory:
    a ``map_shared_rank`` or a call of a helper that makes one."""
    hits = [m.start() for m in re.finditer(r"\bmap_shared_rank\b", body)]
    for h in helpers:
        hits += [m.start() for m in re.finditer(rf"\b{h}\s*<[^;]*?>\s*\(|\b{h}\s*\(", body)]
    return min(hits) if hits else -1


def test_the_scan_finds_the_cluster_kernels():
    names = {k[0] for k in KERNELS}
    assert {"lexn_union.cu:lexn_merge_kernel", "lexn_union.cu:wide_union_kernel"} <= names
    assert "stage_rows" in _helpers(_strip_comments(p.read_text()) for p in SOURCES)


@pytest.mark.parametrize("name,body,helpers", KERNELS, ids=[k[0] for k in KERNELS])
def test_cluster_barrier_before_first_remote_write(name, body, helpers):
    write = first_remote_write(body, helpers)
    assert write >= 0, f"{name} takes a cluster but never reaches another CTA"
    sync = body.find("cluster.sync()")
    assert 0 <= sync < write, (
        f"{name}: its first write into another CTA's shared memory comes before "
        f"its first cluster.sync()")


def test_the_rule_catches_staging_before_the_barrier():
    """The rule on a kernel written the faulting way round."""
    body = ("{ cg::cluster_group cluster = cg::this_cluster();\n"
            "  stage_rows<1024, 1>(p, cluster, sa);\n  cluster.sync(); }")
    write = first_remote_write(body, {"stage_rows"})
    assert 0 <= write < body.find("cluster.sync()")
