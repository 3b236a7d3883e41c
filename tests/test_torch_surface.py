"""The port's surface against the JAX package's: every public name of
``coebslam_tpu`` (a module's top-level functions, classes and assigned
names, and a class's methods) has a counterpart of the same name in the
same module of ``coebslam_tpu_torch``, read from both packages' source
with ``ast`` (nothing is imported). The port's counterpart may be a
definition, an assignment or an import.

The exclusions below are on purpose, each with its reason; a name is not
added to them to make this test pass.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "coebslam_tpu"
PORT_PKG = ROOT / "coebslam_tpu_torch"

#: JAX module -> the port's module that carries its names.
RENAMED = {
    # The one Pallas kernel became a CUDA kernel and its ctypes wrapper.
    "ops/fast_pallas.py": "ops/fast_cuda.py",
}
#: JAX modules the port has no counterpart of, and why.
EXCLUDED_MODULES = {
    # The C++ arena helpers, replaced on purpose by numpy in slam/map.py.
    "native/__init__.py": "numpy in slam/map.py replaces the native library",
}
#: (JAX module, name) pairs the port does not carry, and why.
EXCLUDED_NAMES = {
    ("ops/fast_pallas.py", "HALO"):
        "the Pallas tile's halo; the CUDA kernel keeps its own (csrc/fast.cu)",
}


def _names(path, imports):
    """Top-level names of a module (with ``Class.method`` for methods);
    with ``imports`` the names it imports too."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{b.name}" for b in node.body
                           if isinstance(b, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _public(name):
    return not any(part.startswith("_") for part in name.split("."))


ALL_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))
MODULES = [m for m in ALL_MODULES if m not in EXCLUDED_MODULES]


def test_every_module_is_walked():
    assert len(MODULES) >= 60
    assert set(EXCLUDED_MODULES) <= set(ALL_MODULES)
    assert {m for m, _ in EXCLUDED_NAMES} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_counterparts(module):
    port = PORT_PKG / RENAMED.get(module, module)
    assert port.exists(), f"no counterpart of coebslam_tpu/{module}"
    want = {n for n in _names(JAX_PKG / module, imports=False)
            if _public(n) and (module, n) not in EXCLUDED_NAMES}
    missing = sorted(want - _names(port, imports=True))
    assert not missing, f"coebslam_tpu_torch/{port.relative_to(PORT_PKG)} " \
        f"lacks {missing}"


def test_exclusions_are_still_missing():
    """An excluded name the port has gained is no longer an exclusion."""
    for (module, name) in EXCLUDED_NAMES:
        assert name in _names(JAX_PKG / module, imports=False)
        port = PORT_PKG / RENAMED.get(module, module)
        assert name not in _names(port, imports=True), (module, name)
    for module in EXCLUDED_MODULES:
        assert not (PORT_PKG / module).exists(), module
