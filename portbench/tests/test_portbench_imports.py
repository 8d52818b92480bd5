"""The references import neither JAX, the JAX package nor the port; no
file of the benchmark imports JAX or the JAX package; a run refuses a
process that has loaded either. Top-level names are compared whole:
`repro_torch` is not `repro`."""
import ast
import sys

import pytest

from portbench.harness import guard, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _files(sub=""):
    return sorted(p for p in (registry.ROOT / sub).rglob("*.py")
                  if "__pycache__" not in p.parts and "tests" not in p.parts)


@pytest.mark.parametrize("path", _files("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.name))
def test_no_benchmark_file_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_guard_compares_top_level_names_whole():
    assert guard.loaded({"repro_torch", "repro_torch.kernels",
                         "reproduce"}) == []
    assert guard.loaded({"repro.kernels.ops", "jax._src"}) == ["jax",
                                                               "repro"]


def test_guard_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    with pytest.raises(guard.JaxLoaded, match="jaxlib"):
        guard.check("test")
