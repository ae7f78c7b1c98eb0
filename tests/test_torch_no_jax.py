"""The PyTorch port, chip_smoke.py, chip_profile.py, chip_tv_ab.py,
chip_nccl_mesh.py and the ranks that tests/test_torch_multiprocess.py
spawns (tests/torch_mp_worker.py) import neither jax nor the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "microtipi_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_profile.py", ROOT / "chip_tv_ab.py", ROOT / "chip_nccl_mesh.py",
    ROOT / "tests" / "torch_mp_worker.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "microtipi_tpu"}


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"hyperbolic_tv.py", "vmlmb.py", "blind.py", "batch.py", "tiled.py", "admm.py", "admm_split.py",
            "updaters.py", "convert.py", "richardson_lucy.py", "autotune.py", "uncertainty.py", "regularization.py",
            "chip_smoke.py", "chip_profile.py", "chip_tv_ab.py", "confocal.py", "gibson_lanni.py", "vectorial.py",
            "lightsheet.py", "ism.py", "fourpi.py", "sted.py", "depthconv.py", "depthvar.py", "timeseries.py",
            "multichannel.py", "superres.py", "tiled_blind.py", "phase_retrieval.py", "diversity.py", "sim.py",
            "register.py", "metrics.py", "preprocess.py", "geometry.py", "api.py", "codecs.py", "tiffstack.py",
            "ome.py", "zarr3.py", "zarrstack.py", "hdf5stack.py", "plate.py", "checkpoint.py", "profiling.py",
            "phantoms.py", "parser.py", "shared.py", "basic.py", "deconv.py", "deconv_modes.py", "fitpsf.py",
            "tools.py", "serve.py", "__main__.py", "collectives.py", "torch_mp_worker.py", "chip_nccl_mesh.py"} <= names
    # the io and cli packages' own __init__ (the package's top level is scanned too)
    assert ROOT / "microtipi_tpu_torch" / "io" / "__init__.py" in FILES
    assert ROOT / "microtipi_tpu_torch" / "cli" / "__init__.py" in FILES
    # every module of the sharded paths
    assert {ROOT / "microtipi_tpu_torch" / "parallel" / p.name
            for p in (ROOT / "microtipi_tpu" / "parallel").glob("*.py")} <= set(FILES)


def _all_names(path: pathlib.Path) -> set[str]:
    """The names a module's ``__all__`` lists, read from its source."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return {elt.value for elt in node.value.elts}
    return set()


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "microtipi_tpu" / "parallel").glob("*.py")))
def test_parallel_ports_every_name_of_the_jax_module(name):
    """Each ``microtipi_tpu/parallel`` module's ``__all__`` has a
    counterpart of each of its names in the port's module of that name."""
    jax_names = _all_names(ROOT / "microtipi_tpu" / "parallel" / name)
    assert jax_names, f"microtipi_tpu/parallel/{name} has no __all__"
    assert jax_names <= _all_names(ROOT / "microtipi_tpu_torch" / "parallel" / name)
