"""The readers of the program's own spans inside the swarm engines: on a
small synthetic trace each gives the number its definition says, and
nothing where its span is absent (a program without the span, as an
older commit is) or launched no device work (the CPU twins).  On the card
a traced tiny run of each cell reports every one of them."""
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT
from portbench.traces import Trace

SPEC = harness.Spec(ROOT)

# reader -> (the span it reads, the cell that reports it)
DEVICE_READERS = {
    "round_gather_ms.kv": ("oplog_columnar.gossip_round.gather", "kv-swarm-10k.gossip"),
    "round_gate_ms.kv": ("oplog_columnar.gossip_round.gate", "kv-swarm-10k.gossip"),
    "unstack_ms.kv": ("oplog_columnar.rebuild.unstack", "kv-swarm-10k.read"),
    "view_scatter_ms.kv": ("oplog_columnar.rebuild.scatter", "kv-swarm-10k.read"),
    "member_scatter_ms.orset": ("orset.columnar_member_mask.scatter", "orset-swarm-1m.join"),
}
HALVING = "oplog_columnar.converge.halving"
NEW = {**{k: v[1] for k, v in DEVICE_READERS.items()},
       "halving_issue_us.kv": "kv-swarm-10k.gossip"}


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def three_spans(name: str) -> list:
    """Three ``name`` spans (times in us) inside one parent: the first
    launches two kernels (4 + 6 us of device work), the second one kernel
    (3 us) and a copy (2 us), the third nothing."""
    return [
        ev("user_annotation", "parent", 0, 1000),
        ev("user_annotation", name, 10, 40),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=2),
        ev("kernel", "k1", 30, 4, corr=1),
        ev("kernel", "k2", 40, 6, corr=2),
        ev("user_annotation", name, 100, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 105, 2, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 110, 2, corr=4),
        ev("kernel", "k1", 130, 3, corr=3),
        ev("gpu_memcpy", "copy", 140, 2, corr=4),
        ev("user_annotation", name, 300, 60),
        # device work launched outside every span of the name
        ev("cuda_runtime", "cudaLaunchKernel", 500, 2, corr=5),
        ev("kernel", "k1", 510, 50, corr=5),
    ]


def read(name: str, trace):
    return SPEC.reader(name)(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("name", sorted(DEVICE_READERS))
def test_device_reader_takes_the_median_over_spans_that_launched_work(name):
    span, _ = DEVICE_READERS[name]
    trace = Trace(three_spans(span), window_s=1e-3)
    # 10 us and 5 us: the span that launched nothing is left out
    assert read(name, trace) == pytest.approx(7.5e-3)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_gives_nothing_without_its_span(name):
    other = DEVICE_READERS.get(name, (HALVING,))[0] + ".other"
    assert read(name, Trace(three_spans(other), window_s=1e-3)) is None
    assert read(name, None) is None


@pytest.mark.parametrize("name", sorted(DEVICE_READERS))
def test_device_reader_gives_nothing_when_no_span_launched_work(name):
    span, _ = DEVICE_READERS[name]
    events = [ev("user_annotation", span, 10, 40), ev("user_annotation", span, 100, 20)]
    assert read(name, Trace(events, window_s=1e-3)) is None


def test_halving_issue_reads_the_spans_host_durations():
    # the host durations 40, 20 and 60 us, whatever they launched
    assert read("halving_issue_us.kv", Trace(three_spans(HALVING), window_s=1e-3)) \
        == pytest.approx(40.0)


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_metric_is_reported_by_its_cell_alone(name):
    cells = [c for c, entry in SPEC.cells.items()
             if name in {m["name"] for m in SPEC.metrics(entry, True)}]
    assert cells == [NEW[name]]


def test_cpu_twins_report_host_spans_and_no_device_time(tiny_root):
    """On the CPU the gossip cell's traced run finds the halvings' host
    spans and no device work in the rounds' spans."""
    r = harness.run_cell(tiny_root, "kv-swarm-10k.gossip", 2**31 + 17, 0.3, True, "cpu",
                         time.perf_counter())["result"]
    assert r["correct"], r["compared"]
    assert r["metrics"]["halving_issue_us.kv"]["value"] > 0
    assert "round_gather_ms.kv" not in r["metrics"]
    assert "round_gate_ms.kv" not in r["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(set(NEW.values())))
def test_traced_tiny_cell_on_the_card_reports_its_new_metrics(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = harness.run_cell(tiny_root, cell, 2**31 + 5, 0.5, True, "cuda",
                         time.perf_counter())["result"]
    assert r["correct"], r["compared"]
    for name, home in NEW.items():
        if home == cell:
            assert r["metrics"][name]["value"] > 0, name
