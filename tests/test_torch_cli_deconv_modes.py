"""The port's ``deconv`` against the JAX CLI's over the modes that
``tests/test_torch_cli.py`` does not drive: tiled (VMLMB, RL, weighted ADMM),
FISTA, accelerated Wiener-Butterworth RL under the Gaussian stop, auto-gain
on a padded grid, depth-varying (VMLMB, RL, tiled), superres (synthesized
and coarse PSFs), time series, all channels with and without unmixing, the
5D solve and the plate fan-out. Each case runs both CLIs in process on the
same tiny seeded inputs; the runner and its tolerances are
``tests/torch_cli_modes.py``'s.
"""

import pytest
from torch_cli_modes import FAST, VMLMB_PARTS, O, Q, make_inputs, run_case


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("cli_deconv_modes"))


CASES = {
    "deconv tiled": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif", "--tile", "8", "16", "16",
                      "--overlap", "2", *Q], FAST),
    "deconv tiled rl": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif", "--tile", "8", "16", "16",
                         "--overlap", "2", "--method", "rl", "--iters", "3"], FAST),
    "deconv tiled admm weighted": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif", "--tile", "8",
                                    "16", "16", "--overlap", "2", "0", "2", "--method", "admm", "--gain", "2", *Q],
                                   FAST),
    "deconv fista": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif", "--method", "fista", *Q], FAST),
    "deconv rl wb gaussian stop": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif", "--method", "rl",
                                    "--rl-stop", "gaussian", "--rl-accelerate", "--rl-backprojector", "wb",
                                    "--iters", "5"], FAST),
    "deconv auto-gain pad": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif", "--auto-gain", "--pad",
                              "2", *Q], FAST),
    "deconv depthvar": (["deconv", "{d.tif}", "--out", "{o}/x.tif", "--depthvar", "2", "--model", "gl", *O, *Q],
                        FAST),
    "deconv depthvar rl": (["deconv", "{d.tif}", "--out", "{o}/x.tif", "--depthvar", "2", "--model", "gl",
                            "--method", "rl", *O, "--iters", "3"], FAST),
    "deconv depthvar tiled": (["deconv", "{d.tif}", "--out", "{o}/x.tif", "--depthvar", "2", "--model", "gl",
                               "--tile", "8", "16", "16", "--overlap", "2", *O, *Q], VMLMB_PARTS),
    "deconv superres": (["deconv", "{d.tif}", "--out", "{o}/x.tif", "--superres", "1", "2", "2", *O, *Q], FAST),
    "deconv superres admm coarse psf": (["deconv", "{d.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.tif",
                                         "--superres", "1", "2", "2", "--method", "admm", *Q], FAST),
    "deconv time series": (["deconv", "{ts.ome.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.ome.tif", "--mu-t",
                            "0.01", "--register-t", "--bleach-correct", *Q], FAST),
    "deconv time series admm": (["deconv", "{ts.ome.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.zarr", "--mu-t",
                                 "0.01", "--method", "admm", "--auto-gain", *Q], FAST),
    "deconv channels": (["deconv", "{ch.ome.tif}", "--out", "{o}/x.ome.tif", "--all-channels", "--na", "1.4",
                         "--ni", "1.518", "--n-phase", "3", *Q], FAST),
    "deconv channels mixing admm": (["deconv", "{ch.ome.tif}", "--psf", "{psf.tif}", "--out", "{o}/x.ome.tif",
                                     "--all-channels", "--mixing", "0.8,0.2;0.2,0.8", "--method", "admm", *Q], FAST),
    "deconv 5d": (["deconv", "{tc.ome.tif}", "--out", "{o}/x.ome.tif", "--all-channels", "--mu-t", "0.01",
                   "--register-t", "--bleach-correct", "--na", "1.4", "--ni", "1.518", "--n-phase", "3", *Q],
                  VMLMB_PARTS),
    "deconv plate": (["deconv", "{plate.zarr}", "--psf", "{psf.tif}", "--out", "{o}/x.zarr", *Q], FAST),
    "deconv plate depthvar": (["deconv", "{plate.zarr}", "--out", "{o}/x.zarr", "--depthvar", "2", "--model", "gl",
                               *O, *Q], FAST),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_jax(case, inputs, tmp_path, monkeypatch):
    run_case(*CASES[case], inputs, tmp_path, monkeypatch)
