"""Nothing under portbench/ imports JAX or the JAX package, and the
yardstick (the generators, the plain reference, the rooflines, the trace
reduction and the metric readers) imports nothing of the program.  Top
names are compared whole: ``crdt_tpu_torch`` begins with ``crdt_tpu``."""
import ast

import pytest

from portbench.tests.conftest import ROOT

PORTBENCH = ROOT / "portbench"
FILES = sorted(PORTBENCH.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "crdt_tpu"}
YARDSTICK = [PORTBENCH / f for f in ("gen.py", "reference.py", "roofline.py", "traces.py")] \
    + sorted((PORTBENCH / "metrics").glob("*.py"))


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_names(path) & BANNED


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(ROOT)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "crdt_tpu_torch" not in top_names(path)


def test_the_guard_compares_whole_names(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import crdt_tpu_torch.models\nfrom crdt_tpu_torch import _build\n")
    bad = tmp_path / "bad.py"
    bad.write_text("import importlib\nimportlib.import_module('crdt_tpu.ops')\n")
    assert top_names(ok) == {"crdt_tpu_torch"} and not top_names(ok) & BANNED
    assert top_names(bad) & BANNED == {"crdt_tpu"}
