"""The port's sharded jobs on a mesh over two processes (gloo, float64).

Two spawned ranks (``torch.multiprocessing``, a file rendezvous, so that
parallel test workers never race for a port) run ``tests/torch_mp_worker.py``'s
cases on meshes over both ranks: ``sharded_deconvolve`` and
``sharded_blind_deconvolve`` on (1, 4) as 2 ranks x 2 cells and on (2, 2) as
one row a rank, and ``tests/test_multiprocess.py``'s odd-Nz batched blind
round; ``sharded_deconvolve``'s options (the priors, weights, Poisson, the
temporal and channel-coupled TV, unmixing); and every other sharded solver
(the ADMM engine, with its slab kernels' planes from the other rank, the
blind loop by it, RL-TV, RL of a stack, multi-view RL, the depth-varying
step, fit and blind loop, and one volume on (2, 2), a replica a row). A
second spawn of four ranks, one cell each, runs four of the cases (the
moves' tags must agree across ranks that see different moves; the ADMM
ring's wrap crosses ranks) and three of the options (a rank whose cell reads
nothing from the others must still reach the exchange's backward). Both
spawns also run one PSF fit evaluation (cost and gradient) of one volume on
(1, 4) and on (2, 2), of the wide-field model, a confocal and a light-sheet
one, and one of the depth-varying fit, and count the bytes each rank sent:
each cell synthesizes its own planes of the PSF (a unit-sum family's over
the cells' one sum), so only the pupils' gradient crosses ranks, never a PSF
slab; and one round of a confocal blind loop, its fit included. One spawn
of each serves the module, and the parent computes its references while
they run, then joins the ranks with a deadline and kills them past it.

Each case is held against:

- the same case on a mesh driven by one process, bit for bit, except where a
  (2, 2) mesh fits the PSF: there each rank transforms its own row's replica
  of the PSF, and the rows' gradient contributions are added at the PSF
  rather than at its spectrum, so the fit's gradient rounds otherwise; those
  cases agree to 1e-12 relative; and unmixing, where each row contracts the
  mixing matrix with its own channels' gradient and the rows' results are
  added, to ``tests/test_torch_parallel_jobs.py``'s other-order tolerances
  (F_REL, X_ABS); an unbatched volume on (2, 2) holds on every rank's tiles,
  of either row, the one-process mesh's row 0;
- the JAX package's sharded job on the conftest's virtual devices, to
  ``tests/test_torch_parallel_jobs.py``'s tolerances (F_REL, X_ABS, P_ABS;
  RL to RL_REL);
- its costs falling.

Both ranks end with the same bits. A rank that fails makes the run fail
within the deadline.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_mp_worker as worker

from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.parallel.admm import sharded_admm_deconvolve as jax_sharded_admm
from microtipi_tpu.parallel.blind import sharded_blind_deconvolve as jax_sharded_blind
from microtipi_tpu.parallel.deconv import sharded_deconvolve as jax_sharded_deconvolve
from microtipi_tpu.parallel.depthvar import sharded_deconvolve_depthvar as jax_sharded_depthvar
from microtipi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from microtipi_tpu.parallel.richardson_lucy import sharded_richardson_lucy as jax_sharded_rl
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

F_REL, X_ABS, P_ABS, RL_REL = 1e-8, 1e-6, 1e-7, 1e-8
#: The (2, 2) PSF fits' rounding (see the module docstring).
FIT_REL = 1e-12
#: Every case runs within this many seconds of the spawn.
DEADLINE_S = 120
CASES = ["deconv_1x4", "deconv_2x2", "blind_1x4", "blind_2x2", "odd_2x2"]
FITS_2X2 = {"blind_2x2", "odd_2x2"}
OPTIONS = ["priors_1x4", "weighted_2x2", "poisson_1x4", "series_2x2", "joint_2x2", "mixing_2x2"]
ADMM = ["admm_1x4", "admm_weighted_1x4", "admm_poisson_1x4", "admm_2x2"]
SOLVERS = ADMM + ["blind_admm_1x4", "rl_tv_1x4", "rl_2x2", "multiview_2x2", "depthvar_1x4", "depthvar_fit_1x4",
                  "depthvar_blind_1x4", "unbatched_2x2"]
#: The solvers with a cost: the ADMM solves, the blind loops, the VMLMB steps and the PSF fit.
COSTS = ADMM + ["blind_admm_1x4", "depthvar_1x4", "depthvar_fit_1x4", "depthvar_blind_1x4", "unbatched_2x2"]
#: The new solvers held against the JAX package's sharded job.
JAX_SOLVERS = ["admm_1x4", "rl_tv_1x4", "depthvar_1x4"]


def start(tmp, case: str, world: int) -> tuple:
    """``worker.child`` started as ``world`` spawned ranks."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.child, args=(r, world, f"file://{tmp}/rendezvous", str(tmp), case))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, time.monotonic() + DEADLINE_S


def join(started) -> list:
    """The ranks' exit codes (a rank still running at the deadline is
    killed: -9)."""
    procs, end = started
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def results(tmp, started) -> list:
    """Every rank's saved results, once all exited 0."""
    codes = join(started)
    errors = "".join(p.read_text() for p in sorted(tmp.glob("rank*.err")))
    assert codes == [0] * len(codes), f"exit codes {codes}\n{errors}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(len(codes))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns' results ("two", "four": a list by rank), the cases on
    meshes driven by one process ("one") and the JAX references ("jax"),
    computed while the ranks run."""
    two, four = tmp_path_factory.mktemp("mp2"), tmp_path_factory.mktemp("mp4")
    started = start(two, "jobs", 2), start(four, "few", 4)
    try:
        one = {**worker.run_cases(worker.one_process_mesh), **worker.run_options(worker.one_process_mesh),
               **worker.run_solvers(worker.one_process_mesh), "reductions": worker.run_reductions(worker.one_process_mesh),
               "slab_entries": worker.run_slab_entries(worker.one_process_mesh),
               "fit_evaluations": worker.run_fit_evaluations(worker.one_process_mesh),
               "family_rounds": worker.run_family_rounds(worker.one_process_mesh),
               "object_steps": worker.run_object_steps(worker.one_process_mesh)}
        refs = _jax_refs()
    finally:
        done = results(two, started[0]), results(four, started[1])
    return {"two": done[0], "four": done[1], "one": one, "jax": refs}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["two"]


@pytest.fixture(scope="module")
def four_ranks(runs):
    return runs["four"]


@pytest.fixture(scope="module")
def one_process(runs):
    return runs["one"]


@pytest.fixture(scope="module")
def jax_refs(runs):
    return runs["jax"]


def _jax_refs() -> dict:
    """The JAX package's sharded jobs on the same scenes and mesh shapes."""
    _, psf, data, stack = worker.scene()
    d, s, p = (jnp.asarray(t.numpy()) for t in (data, stack, psf))
    jm = JaxConfig(shape=worker.SHAPE, n_phase=3, radial=True, dtype=jnp.float64, **worker.KW)
    cfg = JaxDeconvConfig(max_iter=15, **worker.CFG)
    blind = JaxBlindConfig(deconv=JaxDeconvConfig(max_iter=5, **worker.CFG), **worker.BLIND)
    odd_model, odd = worker.odd_scene()
    jodd = JaxConfig(shape=worker.ODD_SHAPE, dtype=jnp.float64, **worker.ODD_KW)
    odd_cfg = JaxBlindConfig(deconv=JaxDeconvConfig(**worker.ODD_CFG), **worker.ODD_BLIND)

    def mesh(b, z):
        return jax_make_mesh(b, z, devices=jax.devices()[:b * z])

    def deconv(vol, m):
        r = jax.jit(lambda v, k: jax_sharded_deconvolve(v, k, m, config=cfg))(vol, p)
        return {"f": float(r.f), "x": np.asarray(r.x)}

    def blind_of(vol, model, m, config):
        r = jax.jit(lambda v: jax_sharded_blind(v, model, m, config=config))(vol)
        return {"obj": np.asarray(r.obj), "phase": np.asarray(r.params.phase), "deconv_f": np.asarray(r.deconv_f)}

    _, psfs, _, ddata = worker.depthvar_scene()
    admm = jax.jit(lambda v, k: jax_sharded_admm(v, k, mesh(1, 4), config=cfg, over_relax=1.8))(d, p)
    rl = jax.jit(lambda v, k: jax_sharded_rl(v, k, mesh(1, 4), iterations=10, mu=0.01, epsilon=0.5))(d, p)
    dcfg = JaxDeconvConfig(max_iter=10, **worker.DV_CFG)
    dv = jax.jit(lambda v, k: jax_sharded_depthvar(v, k, mesh(1, 4), worker.ANCHORS, config=dcfg))(
        jnp.asarray(ddata.numpy()), jnp.asarray(psfs.numpy()))
    return {"deconv_1x4": deconv(d, mesh(1, 4)), "deconv_2x2": deconv(s, mesh(2, 2)),
            "blind_1x4": blind_of(d, jm, mesh(1, 4), blind), "blind_2x2": blind_of(s, jm, mesh(2, 2), blind),
            "odd_2x2": blind_of(jnp.asarray(odd.numpy()), jodd, mesh(2, 2), odd_cfg),
            "admm_1x4": {"f": float(admm.f), "x": np.asarray(admm.x)}, "rl_tv_1x4": {"x": np.asarray(rl)},
            "depthvar_1x4": {"f": float(dv.f), "x": np.asarray(dv.x)}}


def _bits(a) -> torch.Tensor:
    """A result's bits (a -0.0 differs from a 0.0)."""
    t = torch.as_tensor(np.asarray(a, dtype=np.float64) if not isinstance(a, torch.Tensor) else a)
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("case", CASES + OPTIONS + SOLVERS)
def test_ranks_agree_bit_for_bit(case, ranks):
    r0, r1 = (r[case] for r in ranks)
    for key in r0.keys() - {"tiles"}:  # each rank's own tiles
        assert torch.equal(_bits(r0[key]), _bits(r1[key])), key


def _same_as_one_process(case, got, ref):
    for key in ref.keys() - {"tiles"}:
        if case in FITS_2X2:
            a, b = (np.asarray(v, dtype=np.float64) for v in (got[key], ref[key]))
            scale = np.nanmax(np.abs(b))
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            assert np.nanmax(np.abs(a - b)) <= FIT_REL * scale, key
        else:
            assert torch.equal(_bits(got[key]), _bits(ref[key])), key


@pytest.mark.parametrize("case", CASES + SOLVERS)
def test_matches_the_one_process_mesh(case, ranks, one_process):
    _same_as_one_process(case, ranks[0][case], one_process[case])


@pytest.mark.parametrize("case", worker.FEW)
def test_four_ranks_of_one_cell_match_the_one_process_mesh(case, four_ranks, one_process):
    for r in four_ranks[1:]:
        for key in r[case].keys() - {"tiles"}:
            assert torch.equal(_bits(r[case][key]), _bits(four_ranks[0][case][key])), key
    _same_as_one_process(case, four_ranks[0][case], one_process[case])


@pytest.mark.parametrize("case", worker.FEW_OPTIONS)
def test_four_ranks_of_one_cell_run_the_options_as_one_process(case, four_ranks, one_process):
    """The priors' planes, the temporal TV's frame and the channel-coupled
    TV's column, where a rank's only cell reads none from the others."""
    for r in four_ranks[1:]:
        for key in r[case]:
            assert torch.equal(_bits(r[case][key]), _bits(four_ranks[0][case][key])), key
    for key in one_process[case]:
        assert torch.equal(_bits(four_ranks[0][case][key]), _bits(one_process[case][key])), key


@pytest.mark.parametrize("case", OPTIONS)
def test_options_match_the_one_process_mesh(case, ranks, one_process):
    got, ref = ranks[0][case], one_process[case]
    assert np.isfinite(got["f"]) and bool(torch.isfinite(got["x"]).all())
    if case == "mixing_2x2":
        assert abs(got["f"] - ref["f"]) <= F_REL * abs(ref["f"])
        assert float((got["x"] - ref["x"]).abs().max()) <= X_ABS
        return
    for key in ref:
        assert torch.equal(_bits(got[key]), _bits(ref[key])), key


@pytest.mark.parametrize("case", CASES + JAX_SOLVERS)
def test_matches_the_jax_sharded_job(case, ranks, jax_refs):
    got, ref = ranks[0][case], jax_refs[case]
    if case.startswith("rl"):
        np.testing.assert_allclose(got["x"].numpy(), ref["x"], rtol=RL_REL, atol=1e-10)
        return
    if "f" in ref:
        assert abs(got["f"] - ref["f"]) <= F_REL * abs(ref["f"])
        assert float(np.abs(got["x"].numpy() - ref["x"]).max()) <= X_ABS
        return
    np.testing.assert_allclose(got["deconv_f"], ref["deconv_f"], rtol=F_REL)
    assert float(np.abs(got["phase"].numpy() - ref["phase"]).max()) <= P_ABS
    assert float(np.abs(got["obj"].numpy() - ref["obj"]).max()) <= X_ABS


@pytest.mark.parametrize("case", CASES + COSTS)
def test_costs_fall_and_stay_finite(case, ranks):
    got = ranks[0][case]
    if case.startswith("admm"):
        # ADMM's objective need not fall every iteration: finite, and below f(x0).
        h = got["f_history"][np.isfinite(got["f_history"])]
        assert np.isfinite(got["f"]) and bool(torch.isfinite(got["x"]).all()) and got["f"] < h[0]
        if case == "admm_weighted_1x4":  # the Boyd test stopped it, on both ranks alike
            assert (got["status"], got["iterations"]) == (0, 15)
        return
    if "deconv_f" not in got:  # VMLMB steps and the PSF fit
        h = got["f_history"][np.isfinite(got["f_history"])]
        assert len(h) > 1 and (np.diff(h) <= 0).all() and np.isfinite(got["f"])
        return
    assert np.isfinite(got["deconv_f"]).all() and got["deconv_f"][1] <= got["deconv_f"][0]
    assert np.isfinite(got["fit_f"][0]).all() and np.isnan(got["fit_f"][-1]).all()  # skip-refit
    assert float(got["phase"][0]) == 0.0  # pin-Z4
    if case == "odd_2x2":
        assert got["obj"].shape == (2, 6, *worker.ODD_SHAPE[1:])  # Nz 5 padded to the z axis


def test_a_failing_rank_fails_the_run_quickly(tmp_path):
    t0 = time.monotonic()
    codes = join(start(tmp_path, "fail", 2))
    assert codes[1] != 0 and codes[0] != 0, codes
    assert "fails before its first collective" in (tmp_path / "rank1.err").read_text()
    assert time.monotonic() - t0 < worker.TIMEOUT_S


@pytest.mark.parametrize("name", ["sum", "amax", "sum_frames", "rows"])
def test_reductions_match_the_one_process_mesh(name, ranks, one_process):
    """A stack's sum, maximum and frame sum, and a per-frame value gathered,
    on every rank bit for bit the one-process mesh's."""
    want = one_process["reductions"][name]
    for r in ranks:
        assert torch.equal(_bits(r["reductions"][name]), _bits(want))


@pytest.mark.parametrize("case", ["admm_2x2", "multiview_2x2", "unbatched_2x2"])
def test_every_row_holds_row_0_of_the_one_process_mesh(case, ranks, one_process):
    """One volume on (2, 2): each rank's tiles, a replica of row 0's on its
    own row, are bit for bit the one-process mesh's row 0 after the solve."""
    want, nzs = one_process[case]["x"], worker.SHAPE[0] // 2
    for row, r in enumerate(ranks):
        assert {int(k.split(",")[0]) for k in r[case]["tiles"]} == {row}  # one row a rank
        for key, tile in r[case]["tiles"].items():
            z = int(key.split(",")[1])
            assert torch.equal(_bits(tile), _bits(want[z * nzs:(z + 1) * nzs])), key


def test_admm_over_processes_runs_the_slab_entries_only(ranks, one_process):
    """Each rank launches the two slab entries once a slab of its own an
    iteration, with planes received from the other rank, and never the
    whole-volume entries (removed for the run)."""
    for r in ranks:
        got = r["slab_entries"]
        assert (got["split"], got["rhs"], got["cells"]) == (12, 12, 2) and got["halo_bytes"] > 0, got
    assert one_process["slab_entries"]["split"] == sum(r["slab_entries"]["split"] for r in ranks) == 24


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("case", ["fit_1x4", "fit_2x2", "depthvar_fit_1x4"])
def test_a_fit_evaluation_sends_the_pupils_gradient_and_no_psf_slab(case, world, runs):
    """One PSF fit evaluation (cost and gradient) on 2 and 4 ranks: each cell
    synthesizes its own planes, so no PSF slab crosses ranks (0 bytes of kind
    "cells"); what crosses is each cell's gradient of the pupil (kind
    "pupil"), at most 3 * Ny * Nx values a cell to each other rank; every
    rank gets the one-process mesh's cost and gradient bit for bit (on (2, 2)
    the replica row's gradient is zero and changes no bit)."""
    ranks, want = runs[world], runs["one"]["fit_evaluations"][case]
    bound = 3 * worker.SHAPE[1] * worker.SHAPE[2] * 8
    for r in ranks:
        got = r["fit_evaluations"][case]
        assert got["sent"].get("cells", 0) == 0, got["sent"]
        assert 0 < got["sent"]["pupil"] <= got["cells"] * (len(ranks) - 1) * bound, got["sent"]
        assert torch.equal(_bits(got["f"]), _bits(want["f"])) and torch.equal(_bits(got["grads"]), _bits(want["grads"]))


def _cell_planes(n: int, nz: int, z: int, step: int) -> list:
    """The model planes cell ``z`` synthesizes for a PSF of ``n`` planes on a
    grid of ``nz`` (``step`` planes a cell), zero-padded in FFT layout
    there (``pad_fft_kernel`` of the plane numbers, -1 a zero plane)."""
    src = (pad_fft_kernel(torch.arange(1.0, n + 1, dtype=torch.float64), (nz,)) - 1).long().tolist()
    return [i for i in src[z * step:(z + 1) * step] if i >= 0]


@pytest.mark.parametrize("case", worker.OBJECT_STEPS)
def test_the_object_step_synthesizes_its_cells_planes_and_moves_no_psf_byte(case, ranks, one_process):
    """One round of each sharded blind loop (the Wiener start and the object
    step) on 2 ranks: each rank synthesizes only its own cells' planes of the
    PSF (the object step's and the start's; the last call is the result's
    whole PSF), no PSF byte crosses ranks (0 bytes of kinds "cells" and
    "pupil"), and the object and ``deconv_f`` are the one-process mesh's bit
    for bit."""
    n = {"odd_2x2": worker.ODD_SHAPE[0]}.get(case, worker.SHAPE[0])
    nz = n + (-n) % 2 if case == "odd_2x2" else n
    z_size = 2 if case == "odd_2x2" else 4
    want = one_process["object_steps"][case]
    for r in ranks:
        got = r["object_steps"][case]
        assert got["sent"].get("cells", 0) == 0 and got["sent"].get("pupil", 0) == 0, got["sent"]
        own = [_cell_planes(n, nz, z, nz // z_size) for z in got["cells"]]
        assert got["calls"] == 2 * own + ["all"], got["calls"]
        for key in ("obj", "deconv_f"):
            assert torch.equal(_bits(got[key]), _bits(want[key])), key


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("case", [f"{f}_fit_{m}" for f in worker.FAMILIES for m in ("1x4", "2x2")])
def test_a_unit_sum_family_fit_evaluation_sends_its_pupils_gradient_and_no_psf_slab(case, world, runs):
    """One fit evaluation of a confocal and of a light-sheet model on 2 and 4
    ranks: each cell synthesizes its own planes, divided by the sum of every
    cell's (a value a cell gathered), so no PSF slab crosses ranks (0 bytes of
    kind "cells"); each cell's gradient of the model's plane inputs (both
    pupils' for the confocal model) goes to every other rank once (kind
    "pupil"); every rank gets the one-process mesh's cost and gradient bit
    for bit."""
    ranks, want = runs[world], runs["one"]["fit_evaluations"][case]
    for r in ranks:
        got = r["fit_evaluations"][case]
        assert got["sent"].get("cells", 0) == 0, got["sent"]
        assert got["sent"]["pupil"] == got["cells"] * (len(ranks) - 1) * got["pupil_values"] * 8, got["sent"]
        assert torch.equal(_bits(got["f"]), _bits(want["f"])) and torch.equal(_bits(got["grads"]), _bits(want["grads"]))


@pytest.mark.parametrize("world", ["two", "four"])
def test_a_confocal_blind_round_moves_no_psf_slab(world, runs):
    """One round of a confocal stack's sharded blind loop (the Wiener start,
    the object step and the joint fit on each cell's planes over the cells'
    one sum) on 2 and 4 ranks: no PSF byte of kind "cells"; the object, its
    cost, the fit's cost and the parameters bit for bit the one-process
    mesh's, the object step's cost below the start's data term."""
    want = runs["one"]["family_rounds"]["confocal_blind_1x4"]
    for r in runs[world]:
        got = r["family_rounds"]["confocal_blind_1x4"]
        assert got["sent"].get("cells", 0) == 0 and got["sent"]["pupil"] > 0, got["sent"]
        for key in ("obj", "deconv_f", "fit_f", "phase", "defocus"):
            assert torch.equal(_bits(got[key]), _bits(want[key])), key
    assert np.isfinite(want["deconv_f"]).all() and np.isfinite(want["fit_f"]).all()
