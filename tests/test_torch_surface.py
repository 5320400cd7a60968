"""The port's public surface against the JAX package's, module by module.

One case per module of ``crdt_tpu``.  The JAX side is read with ``ast``
only (no JAX import); the port's counterpart is imported.  A case asserts:

* every public top-level name the JAX module defines (a function, a class,
  an assignment) is an attribute of the port's module;
* every public method of a class both define is an attribute of the
  port's class (inherited ones count);
* every parameter of such a function or method is a parameter of the
  port's (a ``**kwargs`` does not stand in for a name);
* in a package ``__init__``, every name of its ``__all__`` (or, without
  one, of its ``from … import`` lists) resolves on the port's package.

What the port has in another form sits in ``EXEMPT``, with the reason.
"""
from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "crdt_tpu"

# the port's counterpart of a JAX module that lives under another name
COUNTERPART = {
    "ops/pallas_union.py": "ops/hopper_union.py",
    "analysis/jaxpr_checks.py": "analysis/fx_checks.py",
    "harness/workload.py": "workload.py",
}

# the one list of exemptions: a module ("path"), a name ("path:name"), a
# parameter of one function ("path:qualname(param)"), or a parameter
# anywhere ("*(param)")
EXEMPT = {
    "ops/pallas_union.py": "its kernels are csrc/*.cu behind ops/hopper_union.py",
    "ops/pallas_union.py:LANES": "the TPU's 128-lane vreg; Hopper tiles are TILE_LANES",
    "ops/pallas_union.py:FLAG_SHIFT": "the flag bit lives in csrc/set_union.cu",
    "ops/pallas_union.py:LEXN_PLANE_ROW_BUDGET": "a VMEM budget; Hopper plans from shared memory",
    "ops/pallas_union.py:LEXN_COMPACT_PLANE_ROW_BUDGET": "a VMEM budget; Hopper plans from shared memory",
    "ops/pallas_union.py:bucketed_union_columnar_xla": "the XLA twin; the port's plain twin is the CPU route",
    "ops/pallas_union.py:lexn_fits(n_planes)": "Hopper plans count keys and values apart",
    "ops/pallas_union.py:lexn_compact_fits(n_planes)": "the compaction's shared memory follows its rows",
    "ops/pallas_union.py:sorted_union_columnar_striped_lexn(epilogue)":
        "XLA sort or kernel; the port always ends on lexn_compact",
    "parallel/compat.py": "JAX version drift; torch.distributed needs no shim",
    "analysis/jaxpr_checks.py": "jaxprs become make_fx graphs in analysis/fx_checks.py",
    "harness/workload.py": "lives in crdt_tpu_torch/workload.py",
    "obs/devtime.py:observe_join(fn)": "operand signature: tensor bytes, no XLA cost model",
    "obs/devtime.py:observe_join(args)": "operand signature: tensor bytes, no XLA cost model",
    "analysis/verify/hazards.py:check_join_hazards(jaxpr)": "a make_fx graph (gm) instead",
    "parallel/multihost.py:init_from_env(coordinator_address)":
        "jax.distributed's spelling; torch's is init_method",
    "parallel/multihost.py:init_from_env(num_processes)":
        "jax.distributed's spelling; torch's is world_size",
    "parallel/multihost.py:init_from_env(process_id)": "jax.distributed's spelling; torch's is rank",
    "ops/union_engine.py:engine_bucket(use_kernel)":
        "Pallas or XLA; the port routes by the tensors' device",
    "*(interpret)": "Pallas interpret mode",
    "*(axis)": "a JAX mesh axis name; a torch group has none",
    "*(axis_size)": "a JAX mesh axis size; the group's world size",
    "*(key)": "a JAX PRNG key; the port takes a torch.Generator",
}


def _modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _port_module(rel: str):
    rel = COUNTERPART.get(rel, rel)
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(["crdt_tpu_torch", *parts]))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _assigned(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _top_level(tree: ast.Module):
    """(names defined, {class: {method: FunctionDef}}, {function: FunctionDef})
    at the top of a module, counting bodies of top-level ``if``/``try``."""
    names, classes, funcs = set(), {}, {}

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(n.name)
                funcs[n.name] = n
            elif isinstance(n, ast.ClassDef):
                names.add(n.name)
                classes[n.name] = {m.name: m for m in n.body
                                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
            elif isinstance(n, (ast.If, ast.Try)):
                visit(n.body)
                visit(n.orelse)
                for h in getattr(n, "handlers", ()):
                    visit(h.body)
            else:
                names.update(_assigned(n))
    visit(tree.body)
    return names, classes, funcs


def _reexports(tree: ast.Module) -> set:
    """A package ``__init__``'s exported names: its ``__all__``, else the
    names of its ``from … import`` statements."""
    for n in tree.body:
        if isinstance(n, ast.Assign) and "__all__" in _assigned(n):
            return set(ast.literal_eval(n.value))
    return {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
            and n.module != "__future__" for a in n.names}


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def _missing_params(rel: str, qual: str, fn: ast.FunctionDef, port_obj) -> list:
    try:
        have = set(inspect.signature(port_obj).parameters)
    except (TypeError, ValueError):
        return []
    if isinstance(port_obj, type):
        have.add("self")  # a class's signature is its __init__ without self
    return [p for p in _params(fn) if p not in have and p not in ("self", "cls")
            and f"*({p})" not in EXEMPT and f"{rel}:{qual}({p})" not in EXEMPT]


def surface_gaps(rel: str) -> list:
    """What the port lacks of one JAX module's surface, as readable lines."""
    if rel in EXEMPT and rel not in COUNTERPART:
        return []  # no counterpart at all (the reason is in EXEMPT)
    tree = ast.parse((JAX / rel).read_text(), filename=rel)
    port = _port_module(rel)
    names, classes, funcs = _top_level(tree)
    gaps = []
    want = {n for n in names if _public(n)}
    if rel.endswith("__init__.py"):
        want |= _reexports(tree)
    for name in sorted(want):
        if f"{rel}:{name}" not in EXEMPT and not hasattr(port, name):
            gaps.append(f"name {name}")
    for name, fn in sorted(funcs.items()):
        if _public(name) and hasattr(port, name):
            gaps += [f"parameter {name}({p})"
                     for p in _missing_params(rel, name, fn, getattr(port, name))]
    for cname, methods in sorted(classes.items()):
        cls = getattr(port, cname, None)
        if not _public(cname) or cls is None:
            continue
        for mname, fn in sorted(methods.items()):
            if mname != "__init__" and not _public(mname):
                continue
            if mname != "__init__" and not hasattr(cls, mname):
                gaps.append(f"method {cname}.{mname}")
                continue
            target = cls if mname == "__init__" else inspect.getattr_static(cls, mname)
            if isinstance(target, (staticmethod, classmethod)):
                target = target.__func__
            if callable(target):
                gaps += [f"parameter {cname}.{mname}({p})"
                         for p in _missing_params(rel, f"{cname}.{mname}", fn, target)]
    return gaps


@pytest.mark.parametrize("rel", _modules())
def test_port_has_the_public_surface_of(rel):
    gaps = surface_gaps(rel)
    assert not gaps, f"crdt_tpu/{rel}: the port lacks " + "; ".join(gaps)


def test_every_module_has_a_counterpart_or_an_exemption():
    """A JAX module with no counterpart file fails here rather than as an
    import error inside its case."""
    port = ROOT / "crdt_tpu_torch"
    lost = [rel for rel in _modules()
            if not (port / COUNTERPART.get(rel, rel)).exists()
            and rel not in EXEMPT]
    assert lost == []


def test_exemptions_name_real_things():
    """Each exemption names a module, name or parameter the JAX package
    has, so a stale entry cannot hide a later gap."""
    params = set()
    for rel in _modules():
        _, classes, funcs = _top_level(ast.parse((JAX / rel).read_text()))
        params |= {p for fn in funcs.values() for p in _params(fn)}
        params |= {p for ms in classes.values() for fn in ms.values() for p in _params(fn)}
    for key in EXEMPT:
        if key.startswith("*("):
            assert key[2:-1] in params, key
            continue
        rel, _, rest = key.partition(":")
        assert (JAX / rel).exists(), key
        if not rest:
            continue
        names, classes, funcs = _top_level(ast.parse((JAX / rel).read_text()))
        name, _, param = rest.partition("(")
        assert name in names, key
        if param:
            assert param[:-1] in _params(funcs[name]), key
