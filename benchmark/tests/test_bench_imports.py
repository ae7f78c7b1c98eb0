"""No benchmark module imports JAX or the JAX package; the reference imports
nothing of the port. Top-level module names are compared whole."""

from __future__ import annotations

import ast

import pytest

from benchmark.cell import HERE

SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "microtipi_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_port(path):
    assert "microtipi_tpu_torch" not in _imports(path)


def test_the_port_is_told_apart_from_the_jax_package(monkeypatch):
    import sys
    import types

    from benchmark.cell import forbidden_modules

    for name in ("microtipi_tpu_torch_fake", "microtipi_tpu_fake.sub", "jaxlib_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "microtipi_tpu.ops", types.ModuleType("microtipi_tpu.ops"))
    found = forbidden_modules()
    assert "microtipi_tpu.ops" in found
    assert not {"microtipi_tpu_torch_fake", "microtipi_tpu_fake.sub", "jaxlib_fake"} & set(found)
