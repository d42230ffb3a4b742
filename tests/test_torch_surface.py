"""The port's completeness, read from the sources with ``ast``: neither
package is imported, so these checks cost milliseconds.

1. Module surface: every public top-level function, class and UPPER_CASE
   constant of a module ``optik_tpu/<path>.py``, and every name in its
   ``__all__``, is bound at the top level of ``optik_tpu_torch/<path>.py``
   (``ops/pallas/`` maps to ``ops/cuda/``), by a definition or an import,
   or is listed in ``EXEMPT`` with the reason and where the decision stands.
2. Facade surface: the port's ``Robot`` has every public method of
   ``optik_tpu.Robot`` with the same parameter names in the same order;
   the one addition allowed is ``device`` on the ``from_urdf_*``
   constructors.
3. Kernel coverage: every ``pallas_call`` in the repository's code outside
   the port and the tests is a ``"replaces"`` entry of ``chip_smoke.py``'s
   kernels line, and every such entry names a real call site.

A gap between the two packages shows here first.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "optik_tpu", ROOT / "optik_tpu_torch"

# "<module path under optik_tpu/>:<name>" -> why the port has no such name,
# and where that decision stands.
EXEMPT = {
    "solver/cascade.py:build_cascade_solver":
        "the cascade was dropped; ROADMAP.md, Queue 1, Closed decisions",
    "solver/cascade.py:build_default_solver":
        "the cascade was dropped; ROADMAP.md, Queue 1, Closed decisions",
    "solver/cascade.py:build_multiphase_solver":
        "the cascade was dropped; ROADMAP.md, Queue 1, Closed decisions",
    "ops/soa.py:approx_atan2":
        "kernel math is an explicit approx= flag on each function, not a "
        "context manager; optik_tpu_torch/ops/soa.py, module docstring",
    "utils/precision.py:with_f32_matmuls":
        "the port's counterpart is use_full_f32_matmuls (TF32 off); "
        "optik_tpu_torch/utils/precision.py",
    "utils/roofline.py:op_histogram":
        "the TPU VPU issue-slot model; the port counts operations in "
        "ops/opcount.py; optik_tpu_torch/utils/roofline.py, module docstring",
    "utils/roofline.py:speed_of_light":
        "the TPU VPU issue-slot model; the card's bound is bound_ms; "
        "optik_tpu_torch/utils/roofline.py, module docstring",
    "utils/roofline.py:vpu_peak_flops":
        "the TPU VPU's peak; the card's published peaks are fp32_peak_flops "
        "and memory_peak_bytes; optik_tpu_torch/utils/roofline.py",
    "solver/lm_soa.py:GROUP_ANY":
        "a choice of TPU lowering for the group stop test; the port's hook "
        "is LaneReduce.group_any; optik_tpu_torch/solver/lm_soa.py",
    "ops/pallas/lm_kernel.py:DEFAULT_UNROLL":
        "the Pallas loop's body applications per condition check, a Mosaic "
        "scheduling knob the CUDA kernel's loop does not have; ROADMAP.md, "
        "north star (TPU-era scheduling choices are re-measured, not kept)",
}


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _jax_surface(tree):
    """Public top-level functions, classes, UPPER_CASE constants and the
    names in ``__all__``."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    names.update(e.value for e in node.value.elts)
                elif t.id.isupper():
                    names.add(t.id)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _bound(tree):
    """Every name the module binds at its top level."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0]
                         for a in node.names)
    return names


def _port_path(rel):
    return PORT_PKG / rel.replace("ops/pallas/", "ops/cuda/")


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))


def _missing(rel):
    """Public names of the JAX module the port's module does not bind."""
    port = _port_path(rel)
    have = _bound(_tree(port)) if port.exists() else set()
    return _jax_surface(_tree(JAX_PKG / rel)) - have


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_module_has_the_jax_modules_public_names(rel):
    missing = {n for n in _missing(rel) if f"{rel}:{n}" not in EXEMPT}
    assert not missing, (
        f"{_port_path(rel).relative_to(ROOT)} lacks {sorted(missing)} of "
        f"optik_tpu/{rel}: port them or list them in EXEMPT with a reason")


def test_exemptions_are_current_and_give_a_reason():
    for key, reason in EXEMPT.items():
        rel, name = key.split(":")
        assert (JAX_PKG / rel).exists(), f"{key}: no module optik_tpu/{rel}"
        assert name in _jax_surface(_tree(JAX_PKG / rel)), (
            f"{key}: the JAX package no longer has {name}")
        assert name in _missing(rel), (
            f"{key}: the port now has {name}; drop the exemption")
        assert reason.strip() and "\n" not in reason, key


def _robot_methods(path):
    tree = _tree(path)
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Robot")
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not n.name.startswith("_")}


def _signature(fn):
    a = fn.args
    return {
        "decorators": [ast.unparse(d) for d in fn.decorator_list],
        "positional": [p.arg for p in a.posonlyargs + a.args],
        "varargs": a.vararg and a.vararg.arg,
        "keyword_only": [p.arg for p in a.kwonlyargs],
        "varkw": a.kwarg and a.kwarg.arg,
    }


# Parameters the port adds, by method, at the end of the positional list.
ROBOT_ADDED = {"from_urdf_file": ["device"], "from_urdf_str": ["device"]}
JAX_ROBOT_METHODS = sorted(_robot_methods(JAX_PKG / "robot.py"))


@pytest.mark.parametrize("name", JAX_ROBOT_METHODS)
def test_port_robot_method_matches_jax(name):
    port = _robot_methods(PORT_PKG / "robot.py")
    assert name in port, f"optik_tpu_torch.Robot lacks {name}"
    want = _signature(_robot_methods(JAX_PKG / "robot.py")[name])
    want["positional"] += ROBOT_ADDED.get(name, [])
    assert _signature(port[name]) == want


# Directories whose .py files are not the repository's code with TPU
# kernels: the port, the tests, and the gitignored build outputs.
NOT_SCANNED = {"optik_tpu_torch", "tests", "build", "dist", "__pycache__"}


def _scanned_files(directory=ROOT):
    for path in sorted(directory.iterdir()):
        if path.is_dir():
            if path.name not in NOT_SCANNED and not path.name.startswith("."):
                yield from _scanned_files(path)
        elif path.suffix == ".py":
            yield path


def pallas_call_sites():
    """``file:line`` of every call of ``pallas_call`` in the code (comments
    and docstrings do not count)."""
    sites = set()
    for path in _scanned_files():
        for node in ast.walk(_tree(path)):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "pallas_call") or (
                    isinstance(f, ast.Name) and f.id == "pallas_call"):
                sites.add(f"{path.relative_to(ROOT).as_posix()}:{f.lineno}")
    return sites


def chip_smoke_replaces():
    """Every ``"replaces"`` value of a dict literal in chip_smoke.py."""
    return {v.value for node in ast.walk(_tree(ROOT / "chip_smoke.py"))
            if isinstance(node, ast.Dict)
            for k, v in zip(node.keys, node.values)
            if isinstance(k, ast.Constant) and k.value == "replaces"
            and isinstance(v, ast.Constant)}


def test_every_pallas_call_site_has_a_kernel_in_chip_smoke():
    sites = pallas_call_sites()
    assert sites, "no pallas_call found: the scan is broken"
    unported = sites - chip_smoke_replaces()
    assert not unported, (
        f"pallas_call sites with no kernel in chip_smoke.py: "
        f"{sorted(unported)}")


def test_every_replaces_entry_names_a_pallas_call_site():
    stale = chip_smoke_replaces() - pallas_call_sites()
    assert not stale, (
        f"chip_smoke.py replaces entries that name no pallas_call: "
        f"{sorted(stale)}")
