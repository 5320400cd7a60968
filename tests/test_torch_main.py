"""``python -m crdt_tpu_torch``, the port's demo (the reference's ``go run
main.go``): it serves, writes, gossips and converges with ``--device cpu``;
without a card and without ``--device`` it fails rather than fall back to
the CPU; ``--daemon`` runs one network replica (tests/test_torch_net.py
drives a fleet of them, a crash and a restore)."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def demo(*args, timeout=180):
    return subprocess.run([sys.executable, "-m", "crdt_tpu_torch", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_demo_converges_on_the_cpu():
    out = demo("--device", "cpu", "--duration", "3", "--ephemeral-ports", "--write-ms", "5")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("serving 5 replicas: http://127.0.0.1:")
    assert lines[-1].startswith("final: writes=") and "converged=True" in lines[-1]
    assert int(lines[-1].split("writes=")[1].split()[0]) > 0


def test_demo_without_a_card_fails_rather_than_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    out = demo("--duration", "1", "--ephemeral-ports", timeout=60)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "serving" not in out.stdout


def test_daemon_serves_on_the_cpu():
    """``--daemon`` boots one replica, serves, and exits 0 at the end of
    its --duration."""
    out = demo("--daemon", "--device", "cpu", "--port", "0", "--duration", "1", timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("replica rid=0 (base 0, incarnation 0, restored=False) "
                               "serving on http://127.0.0.1:")
    assert lines[-1] == "final: state_keys=0"
