"""The JAX package's native runtime (``crdt_tpu/native``), built once before
any test process imports it.

Its loader builds the library at import with ``make``, with no lock, and
``make`` writes the library in place.  So when several pytest-xdist
workers import it at once on a checkout that has no library yet, a worker
can load a half-written one and keep ``AVAILABLE = False`` for its whole
life.  ``tests/conftest.py`` runs :func:`build_once` in the controller,
before the workers start; the workers then find the library built.
"""
from __future__ import annotations

import fcntl
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = ROOT / "crdt_tpu" / "native"
LOCK = ROOT / "build" / "native" / "crdt_tpu_native.lock"


def build_once(native_dir: Path = NATIVE_DIR, lock: Path = LOCK) -> None:
    """Run the module's own ``make`` under an exclusive lock on ``lock``, so
    that two test runs never write the library at once; ``make`` leaves a
    library that is up to date as it is.  A failed build raises nothing
    here: the twin tests then fail, naming it (``jax_native``)."""
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(native_dir), "-s"], capture_output=True, check=False)


def require_jax_native():
    """The JAX package's native runtime, loaded; a test that compares with
    it calls this first, and fails with this one message when it did not
    load."""
    import pytest

    from crdt_tpu import native

    if not native.AVAILABLE:
        pytest.fail(
            f"crdt_tpu.native did not load (AVAILABLE is False): its library "
            f"{native._SO} did not build or load; `make -C {native._DIR}` shows why",
            pytrace=False)
    return native
