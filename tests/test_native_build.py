"""The test run's build of the JAX package's native runtime
(``tests/native_build.py``, run by ``tests/conftest.py`` in the xdist
controller): after it, processes that import the module at once each
load the library, and the workers never build it themselves."""
import shutil
import subprocess
import sys
from types import SimpleNamespace

from tests import conftest, native_build

IMPORT = ("import importlib.util, sys; "
          "spec = importlib.util.spec_from_file_location('native_copy', sys.argv[1]); "
          "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
          "print(m.AVAILABLE)")


def test_concurrent_imports_after_the_build_each_load_the_library(tmp_path):
    copy = tmp_path / "native"
    copy.mkdir()
    for name in ("__init__.py", "ingest.cpp", "Makefile"):
        shutil.copy(native_build.NATIVE_DIR / name, copy / name)
    library = copy / "libcrdt_ingest.so"
    assert not library.exists()
    native_build.build_once(copy, tmp_path / "build.lock")
    assert library.exists()
    built = library.stat().st_mtime_ns
    procs = [subprocess.Popen([sys.executable, "-c", IMPORT, str(copy / "__init__.py")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert [o.strip().splitlines()[-1] for o, _ in outs] == ["True"] * 6
    assert library.stat().st_mtime_ns == built  # no importer built it again


def test_only_the_controller_builds(monkeypatch):
    calls = []
    monkeypatch.setattr(native_build, "build_once", lambda: calls.append(1))
    config = SimpleNamespace(addinivalue_line=lambda *a: None)
    conftest.pytest_configure(config)
    assert calls == [1]
    config.workerinput = {"workerid": "gw0"}
    conftest.pytest_configure(config)
    assert calls == [1]
