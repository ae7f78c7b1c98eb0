"""The port's other commands against the JAX CLI's over the modes that
``tests/test_torch_cli.py`` and ``tests/test_torch_cli_tools.py`` do not
drive: blind over all channels, depth-varying and checkpointed under the
calibration prior; the depth ladder, phase diversity, pupil retrieval and the
empirical PSF; fusion, ISM, 2D SIM with pattern refinement, 3D SIM, channel
registration; ``watch`` by blind-once and depth-varying. The tiled blind loop
is held against JAX by ``tests/test_torch_tiled_blind.py``. Each case runs
both CLIs in process on the same tiny seeded inputs; the runner and its
tolerances are ``tests/torch_cli_modes.py``'s.
"""

import pytest
from torch_cli_modes import FAST, VMLMB_PARTS, O, Q, make_inputs, run_case


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("cli_other_modes"))


CASES = {
    "blind channels": (["blind", "{ch.ome.tif}", "--out", "{o}/x.ome.tif", "--all-channels", "--na", "1.4", "--ni",
                        "1.518", "--n-phase", "3", "--loops", "2", "--psf-iters", "2", *Q], VMLMB_PARTS),
    "blind depthvar": (["blind", "{d.tif}", "--out", "{o}/x.tif", "--depthvar", "2", "--model", "gl", *O, "--loops",
                        "2", "--psf-iters", "2", "--psf-out", "{o}/h.tif", *Q], VMLMB_PARTS),
    "blind checkpoint prior": (["blind", "{d.tif}", "--out", "{o}/x.tif", "--checkpoint", "{o}/c.npz",
                                "--phase-prior", "0.01", *O, "--loops", "2", "--psf-iters", "2", *Q], VMLMB_PARTS),
    "fitpsf depth ladder": (["fitpsf", "{bead.tif}", "{bead.tif}", "--depth-ladder", "0", "2", "--model", "gl", *O,
                             "--iters", "3", "--uncertainty", "--out", "{o}/x.tif"], FAST),
    "fitpsf diversity": (["fitpsf", "{d.tif}", "{v2.tif}", "--diversity-dz=-2e-7,2e-7", *O, "--iters", "3",
                          "--uncertainty", "--object-out", "{o}/obj.tif", "--out", "{o}/x.tif"], FAST),
    "fitpsf retrieve map": (["fitpsf", "{bead.tif}", *O, "--iters", "2", "--retrieve-map", "{o}/map.npz", "--out",
                             "{o}/x.tif", "--centered"], FAST),
    "fitpsf empirical": (["fitpsf", "{beads2.tif}", "--empirical-out", "{o}/x.tif", "--n-beads", "2",
                          "--bead-patch", "8", "16", "16"], FAST),
    "fuse": (["fuse", "{d.tif}", "{v2.tif}", "--psf", "{psf.tif}", "{psf.tif}", "--out", "{o}/x.tif", "--iters", "3"],
             FAST),
    "ism rl": (["ism", "{ism.tif}", "--out", "{o}/x.tif", "--pitch", "4e-8", "--rings", "1", "--method", "rl",
                "--iters", "3", "--auto-gains", "--psf-out", "{o}/h.tif", *O], FAST),
    "sim 2d refine": (["sim", "{sim.tif}", "--out", "{o}/x.tif", "--pattern-period", "2.5e-7", "--refine", *O], FAST),
    "sim 3d": (["sim", "{sim3.tif}", "--out", "{o}/x.tif", "--pattern-period", "2.5e-7", "--phase-count", "5",
                "--axial-period", "4e-7", *O], FAST),
    "register channels": (["register", "{ch.ome.tif}", "--align-channels", "--out", "{o}/x.ome.tif"], FAST),
    "watch blind-once": (["watch", "{win}", "{o}/out", "--method", "blind-once", "--max-files", "1", "--poll",
                          "0.05", "--loops", "2", "--psf-iters", "2", *O, *Q], FAST),
    "watch depthvar": (["watch", "{win}", "{o}/out", "--depthvar", "2", "--model", "gl", "--max-files", "1",
                        "--poll", "0.05", *O, *Q], FAST),



}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_jax(case, inputs, tmp_path, monkeypatch):
    run_case(*CASES[case], inputs, tmp_path, monkeypatch)
