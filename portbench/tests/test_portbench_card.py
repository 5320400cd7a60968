"""The measurement path needs the card: without one it exits non-zero and
prints no result.  With a card, a tiny run of each cell through the
hand-written kernels comes out correct."""
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT

CELLS = ("kv-swarm-10k.gossip", "kv-swarm-10k.read", "orset-swarm-1m.join")


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                       "--trace", "0"], time.perf_counter(), ROOT)
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = harness.run_cell(tiny_root, cell, 2**31 + 3, 0.5, True, "cuda",
                         time.perf_counter())["result"]
    assert r["correct"], r["compared"]
    assert r["device"]["busy_s"] > 0
