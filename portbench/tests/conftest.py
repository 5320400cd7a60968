"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary directory with every configuration cut to a size the CPU runs
in moments.  The cells then run on the program's CPU twins."""
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# each configuration at a tiny size: the same shapes, fewer replicas, rows
# and writes
TINY = {
    "kv-swarm-10k": {"replicas": 512, "capacity": 64, "burst_writes": 50},
    "orset-swarm-1m": {"replicas": 96, "capacity": 64, "elems": 64, "writers": 8,
                       "tags_per_writer": 8},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips inside the test when none is present")


def copy_benchmark(dest: Path, sizes: dict = TINY) -> Path:
    """BENCHMARK.json and portbench/ under ``dest``, the configurations
    resized by ``sizes``; returns ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for entry in spec["configs"]:
        path = dest / entry["file"]
        config = json.loads(path.read_text())
        config.update(sizes.get(entry["name"], {}))
        path.write_text(json.dumps(config))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return copy_benchmark(tmp_path)
