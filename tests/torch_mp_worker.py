"""The ranks of ``tests/test_torch_multiprocess.py``.

Each child is one rank of a gloo group (``torch.distributed``, a file
rendezvous): it runs the port's sharded jobs on meshes over the ranks and
saves what it got for the parent to compare. The same :func:`run_cases` on
meshes driven by one process gives the parent its reference. Imports torch
and the port only (a child never loads JAX).
"""

import datetime
import pathlib
import traceback

import numpy as np
import torch
import torch.distributed as dist

from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.depthvar import depth_anchor_psfs
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.models.confocal import ConfocalConfig, ConfocalModel
from microtipi_tpu_torch.models.gibson_lanni import GibsonLanniConfig, GibsonLanniModel
from microtipi_tpu_torch.models.lightsheet import LightSheetConfig, LightSheetModel
from microtipi_tpu_torch.models.microscope import DEFOCUS, DEPTH, PHASE
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost
from microtipi_tpu_torch.parallel import (
    gather,
    make_mesh,
    sharded_admm_deconvolve,
    sharded_blind_deconvolve,
    sharded_deconvolve,
)
from microtipi_tpu_torch.parallel import depthvar as sdv
from microtipi_tpu_torch.parallel.richardson_lucy import sharded_multiview_richardson_lucy, sharded_richardson_lucy

#: ``tests/test_torch_parallel_jobs.py``'s scene and optics.
SHAPE = (16, 32, 32)
KW = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9)
CFG = dict(mu=0.002, epsilon=1.0, grtol=0.0)
BLIND = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), joint_fit=True, phase_freeze_head=1,
             init="wiener")
#: ``tests/test_multiprocess.py``'s case (``__graft_entry__._mp_worker``) on
#: a (2, 2) mesh: Nz = 2 * 2 + 1 (the zero-weight padding), 16 x 16, in float64.
ODD_SHAPE = (5, 16, 16)
ODD_KW = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=3, n_modulus=1)
ODD_BLIND = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(2, 2), joint_fit=True, phase_freeze_head=1,
                 init="wiener")
ODD_CFG = dict(mu=0.01, epsilon=1.0, max_iter=2, grtol=0.0)
#: ``tests/test_torch_parallel_depthvar.py``'s Gibson-Lanni scene: 3 anchors.
ANCHORS = np.array([0.0, 7.5, 15.0])
GL_KW = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=4, ns=1.38, depth=10e-6)
DV_CFG = dict(mu=0.01, epsilon=1.0, grtol=0.0, gatol=0.0)
#: The Boyd-stopped ADMM case: its test passes at the third check (iteration 15).
BOYD = dict(max_iter=100, admm_abstol=1e-2, admm_reltol=1e-2, admm_check_every=5)
#: A rank that waits on a dead peer gives up after this many seconds.
TIMEOUT_S = 30
#: The cases a spawn of four ranks (one cell each) runs: on (1, 4) the ADMM
#: ring's wrap from slab 3 to slab 0 crosses ranks.
FEW = ("deconv_1x4", "odd_2x2", "admm_1x4", "rl_tv_1x4")
#: The options it runs: on them a rank whose cell reads no other cell's
#: planes or frames (the last slab, the last row) still takes part in the
#: exchange that sends its own to the others.
FEW_OPTIONS = ("priors_1x4", "series_2x2", "joint_2x2")


def scene():
    """(model, psf, data, stack): the parallel jobs test's scene (made from
    numpy, the same in every process) and a 2-frame stack of it."""
    model = WideFieldModel(WideFieldConfig(shape=SHAPE, n_phase=3, radial=True, dtype=torch.float64, **KW),
                           device="cpu")
    true = model.init_params()._replace(phase=torch.tensor([0.4, -0.2, 0.1], dtype=torch.float64))
    obj = np.zeros(SHAPE)
    obj[4:10, 8:20, 8:20] = 60.0
    obj[10:14, 20:28, 4:12] = 90.0
    obj = torch.as_tensor(obj)
    with torch.no_grad():
        psf = model.compute_psf(true)
        data = convolve(obj, convolve_spectrum(psf), SHAPE)
    data = data + 0.01 * torch.as_tensor(np.random.default_rng(0).standard_normal(SHAPE))
    return model, psf, data, torch.stack([data, 1.1 * data])


def odd_scene():
    """(model, data) of the odd-Nz batched case."""
    model = WideFieldModel(WideFieldConfig(shape=ODD_SHAPE, dtype=torch.float64, **ODD_KW), device="cpu")
    return model, torch.as_tensor(np.random.default_rng(0).random((2, *ODD_SHAPE)))


def depthvar_scene():
    """(model, anchor psfs, object, data) of the depth-varying cases."""
    model = GibsonLanniModel(GibsonLanniConfig(shape=SHAPE, dtype=torch.float64, **GL_KW), device="cpu")
    true = model.init_params()._replace(phase=torch.tensor([0.2, -0.1, 0.05, 0.1], dtype=torch.float64))
    with torch.no_grad():
        psfs = depth_anchor_psfs(model, true, ANCHORS)
        rng = np.random.default_rng(0)
        obj = torch.as_tensor((rng.random(SHAPE) > 0.97) * rng.random(SHAPE) * 100.0)
        data = DepthVaryingConvCost.build(psfs, obj, None, SHAPE, ANCHORS).model(obj)
    return model, psfs, obj, data + 0.01 * torch.as_tensor(rng.standard_normal(SHAPE))


def family_scene(family: str):
    """(model, params, obj, data) of a unit-sum family at SHAPE: a confocal
    model with a pinhole, or a light sheet; the data blurred by its PSF at
    an aberration, with 1% noise; the params another aberration."""
    if family == "confocal":
        model = ConfocalModel(ConfocalConfig(shape=SHAPE, dtype=torch.float64, n_phase=3, wavelength_exc=488e-9,
                                             pinhole=150e-9, **KW), device="cpu")
    else:
        model = LightSheetModel(LightSheetConfig(shape=SHAPE, dtype=torch.float64, n_phase=3, sheet_na=0.15,
                                                 wavelength_exc=488e-9, **KW), device="cpu")
    true = model.init_params()._replace(phase=torch.tensor([0.4, -0.2, 0.1], dtype=torch.float64))
    _, _, obj, _ = depthvar_scene()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        data = convolve(obj, convolve_spectrum(model.compute_psf(true)), SHAPE)
    data = data + 0.01 * float(data.max()) * torch.as_tensor(rng.standard_normal(SHAPE))
    return model, true._replace(phase=torch.tensor([0.3, -0.1, 0.05], dtype=torch.float64)), obj, data


def _deconv(res) -> dict:
    return {"x": gather(res.x), "f": res.f, "f_history": res.f_history}


def _solve(res) -> dict:
    """A solve's result, with this rank's tiles (an unbatched volume's
    replicas on every row of a mesh over processes) and its stop."""
    return {**_deconv(res), "tiles": _tiles(res.x), "iterations": res.iterations, "status": res.status}


def _tiles(x) -> dict:
    return {f"{b},{z}": t for (b, z), t in x.tiles.items()}


def _estimate(x) -> dict:
    """An RL estimate, whole and as this rank's tiles."""
    return {"x": gather(x), "tiles": _tiles(x)}


def _fit(res) -> dict:
    return {"defocus": res.params.defocus.detach(), "depth": res.params.depth.detach(), "f": res.f,
            "f_history": res.f_history}


def _blind(res) -> dict:
    return {"obj": gather(res.obj), "phase": res.params.phase.detach(), "defocus": res.params.defocus.detach(),
            "deconv_f": res.deconv_f, "fit_f": res.fit_f}


def run_cases(mesh_of, only=None) -> dict:
    """Every case (or those named in ``only``) on the meshes ``mesh_of(batch,
    z)`` makes."""
    model, psf, data, stack = scene()
    cfg = DeconvolutionConfig(max_iter=15, **CFG)
    blind = BlindDeconvConfig(deconv=DeconvolutionConfig(max_iter=5, **CFG), **BLIND)
    odd_model, odd = odd_scene()
    runs = {
        "deconv_1x4": lambda: _deconv(sharded_deconvolve(data, psf, mesh_of(1, 4), config=cfg)),
        "deconv_2x2": lambda: _deconv(sharded_deconvolve(stack, psf, mesh_of(2, 2), config=cfg)),
        "blind_1x4": lambda: _blind(sharded_blind_deconvolve(data, model, mesh_of(1, 4), config=blind)),
        "blind_2x2": lambda: _blind(sharded_blind_deconvolve(stack, model, mesh_of(2, 2), config=blind)),
        "odd_2x2": lambda: _blind(sharded_blind_deconvolve(odd, odd_model, mesh_of(2, 2), config=BlindDeconvConfig(
            deconv=DeconvolutionConfig(**ODD_CFG), **ODD_BLIND))),
    }
    return {name: run() for name, run in runs.items() if only is None or name in only}


def run_options(mesh_of, only=None) -> dict:
    """``sharded_deconvolve``'s options (or those named in ``only``) over the
    meshes ``mesh_of(batch, z)`` makes: ``tests/test_torch_parallel_jobs.py``'s
    priors, weights with a NaN at a zero weight, Poisson deviance, and the
    row-coupled frames (temporal TV with bleaching gains, channel-coupled TV,
    unmixing)."""
    _, psf, data, stack = scene()
    cfg = DeconvolutionConfig(max_iter=10, **CFG)
    w = torch.as_tensor(0.5 + np.random.default_rng(1).random((2, *SHAPE)))
    w[0, 0, 0, 0] = 0.0
    bad = stack.clone()
    bad[0, 0, 0, 0] = float("nan")
    psfs = torch.stack([psf, psf.roll(1, 1)])
    mix = torch.tensor([[0.85, 0.25], [0.15, 0.75]], dtype=torch.float64)
    runs = {
        "priors_1x4": lambda: sharded_deconvolve(data, psf, mesh_of(1, 4), config=DeconvolutionConfig(
            max_iter=12, sparsity=0.01, sparsity_epsilon=0.05, hessian=0.05, **CFG)),
        "weighted_2x2": lambda: sharded_deconvolve(bad, psf, mesh_of(2, 2), weights=w, x0=torch.clamp_min(stack, 0.0),
                                                   config=cfg),
        "poisson_1x4": lambda: sharded_deconvolve(torch.clamp_min(data, 0.0) + 1.0, psf, mesh_of(1, 4),
                                                  config=DeconvolutionConfig(max_iter=10, data_term="poisson",
                                                                             background=0.5, **CFG)),
        "series_2x2": lambda: sharded_deconvolve(stack, psf, mesh_of(2, 2), config=cfg, mu_t=0.01,
                                                 bleach=torch.tensor([1.0, 0.9], dtype=torch.float64)),
        "joint_2x2": lambda: sharded_deconvolve(stack, psfs, mesh_of(2, 2), config=cfg, joint_channels=True),
        "mixing_2x2": lambda: sharded_deconvolve(stack, psfs, mesh_of(2, 2), config=cfg, mixing=mix),
    }
    return {name: _deconv(run()) for name, run in runs.items() if only is None or name in only}


def run_solvers(mesh_of, only=None) -> dict:
    """The other sharded solvers (or those named in ``only``) over the meshes
    ``mesh_of(batch, z)`` makes: the ADMM engine (uniform, weighted with the
    Boyd stop, Poisson, one volume on (2, 2)) and the blind loop by it; RL-TV,
    RL of a stack and multi-view RL; the depth-varying object step, PSF fit
    and blind loop; VMLMB of one volume on (2, 2), weighted and with the
    priors, whose sums count row 0's tiles."""
    model, psf, data, stack = scene()
    cfg = DeconvolutionConfig(max_iter=15, **CFG)
    w = torch.as_tensor(0.5 + np.random.default_rng(1).random(SHAPE))
    gl, psfs, obj, ddata = depthvar_scene()
    dcfg = DeconvolutionConfig(max_iter=10, **DV_CFG)
    priors = DeconvolutionConfig(max_iter=12, sparsity=0.01, sparsity_epsilon=0.05, hessian=0.05, **CFG)
    runs = {
        "admm_1x4": lambda: _solve(sharded_admm_deconvolve(data, psf, mesh_of(1, 4), config=cfg, over_relax=1.8)),
        "admm_weighted_1x4": lambda: _solve(sharded_admm_deconvolve(
            data, psf, mesh_of(1, 4), weights=w, config=DeconvolutionConfig(**BOYD, **CFG), track_objective=False)),
        "admm_poisson_1x4": lambda: _solve(sharded_admm_deconvolve(
            torch.clamp_min(data, 0.0) + 1.0, psf, mesh_of(1, 4),
            config=DeconvolutionConfig(max_iter=10, data_term="poisson", background=0.5, **CFG))),
        "admm_2x2": lambda: _solve(sharded_admm_deconvolve(data, psf, mesh_of(2, 2), config=cfg)),
        "blind_admm_1x4": lambda: _blind(sharded_blind_deconvolve(data, model, mesh_of(1, 4), config=BlindDeconvConfig(
            deconv=DeconvolutionConfig(max_iter=5, **CFG), deconv_engine="admm", **BLIND))),
        "rl_tv_1x4": lambda: _estimate(sharded_richardson_lucy(data, psf, mesh_of(1, 4), iterations=10, mu=0.01,
                                                               epsilon=0.5)),
        "rl_2x2": lambda: _estimate(sharded_richardson_lucy(stack, psf, mesh_of(2, 2), iterations=10, mu=0.01,
                                                            epsilon=0.5)),
        "multiview_2x2": lambda: _estimate(sharded_multiview_richardson_lucy(
            stack, torch.stack([psf, psf.roll(1, 0)]), mesh_of(2, 2), iterations=5)),
        "depthvar_1x4": lambda: _solve(sdv.sharded_deconvolve_depthvar(ddata, psfs, mesh_of(1, 4), ANCHORS,
                                                                       config=dcfg)),
        "depthvar_fit_1x4": lambda: _fit(sdv.sharded_fit_psf_depthvar(
            gl, gl.init_params(), (DEFOCUS, DEPTH), ddata, obj, mesh_of(1, 4), ANCHORS,
            config=PsfFitConfig(max_iter=6, grtol=0.0))),
        "depthvar_blind_1x4": lambda: _blind(sdv.sharded_blind_deconvolve_depthvar(
            ddata, gl, mesh_of(1, 4), ANCHORS, config=BlindDeconvConfig(
                loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True, phase_freeze_head=1,
                deconv=DeconvolutionConfig(max_iter=5, **DV_CFG)))),
        "unbatched_2x2": lambda: _solve(sharded_deconvolve(data, psf, mesh_of(2, 2), weights=w, config=priors)),
    }
    return {name: run() for name, run in runs.items() if only is None or name in only}


def run_slab_entries(mesh_of) -> dict:
    """How often a 6-iteration ADMM solve on (1, 4) called each slab entry
    on this rank, with the whole-volume entries removed, and the bytes of
    halo planes it sent to other ranks."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak
    from microtipi_tpu_torch.parallel import admm as padmm
    from microtipi_tpu_torch.parallel import collectives

    _, psf, data, _ = scene()
    calls, saved = {"split": 0, "rhs": 0}, (padmm.admm_split_update_slab, padmm.admm_rhs_slab, ak.admm_split_update,
                                            ak.admm_rhs)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    padmm.admm_split_update_slab, padmm.admm_rhs_slab = count("split", saved[0]), count("rhs", saved[1])
    ak.admm_split_update = ak.admm_rhs = None
    collectives.sent.clear()
    try:
        mesh = mesh_of(1, 4)
        sharded_admm_deconvolve(data, psf, mesh, config=DeconvolutionConfig(max_iter=6, **CFG))
    finally:
        padmm.admm_split_update_slab, padmm.admm_rhs_slab, ak.admm_split_update, ak.admm_rhs = saved
    return {**calls, "cells": len(mesh.local(mesh.cells())), "halo_bytes": collectives.sent["halo"]}


def run_reductions(mesh_of) -> dict:
    """A stack's reductions on a (2, 2) mesh from ``mesh_of``: ``sum``,
    ``amax``, ``sum_frames`` and the per-frame values' ``gather``."""
    from microtipi_tpu_torch.parallel import shard
    from microtipi_tpu_torch.parallel.mesh import shard_rows

    _, _, _, stack = scene()
    mesh = mesh_of(2, 2)
    v = shard(stack, mesh)
    gains = torch.tensor([1.0, 0.9], dtype=torch.float64).reshape(2, 1, 1, 1)
    return {"sum": v.sum(), "amax": v.amax(), "sum_frames": gather(v.sum_frames()),
            "rows": gather(shard_rows(gains, mesh))}


def run_fit_evaluations(mesh_of) -> dict:
    """One PSF fit evaluation, cost and gradient, on the meshes ``mesh_of(batch,
    z)`` makes: ``sharded_fit_cost`` of one volume on (1, 4) and on (2, 2)
    (a replica a row), the depth-varying fit's cost on (1, 4), and a confocal
    and a light-sheet fit's cost (:func:`family_scene`) on both; each with
    the bytes this rank sent by kind, its number of cells and the number of
    values in the model's plane inputs."""
    from microtipi_tpu_torch.parallel import collectives
    from microtipi_tpu_torch.parallel.psf_fit import sharded_fit_cost

    model, _, data, _ = scene()
    gl, _, obj, ddata = depthvar_scene()
    p = model.init_params()._replace(phase=torch.tensor([0.3, -0.1, 0.05], dtype=torch.float64))
    costs = {"fit_1x4": (model, p, lambda: sharded_fit_cost(model, data, obj, None, mesh_of(1, 4)), (1, 4)),
             "fit_2x2": (model, p, lambda: sharded_fit_cost(model, data, obj, None, mesh_of(2, 2)), (2, 2)),
             "depthvar_fit_1x4": (gl, gl.init_params(), lambda: sdv.sharded_depthvar_fit_cost(
                 gl, ddata, obj, None, mesh_of(1, 4), ANCHORS), (1, 4))}
    for family in FAMILIES:
        fm, fp, fobj, fdata = family_scene(family)
        for b, z in ((1, 4), (2, 2)):
            costs[f"{family}_fit_{b}x{z}"] = (fm, fp, lambda fm=fm, fobj=fobj, fdata=fdata, b=b, z=z: sharded_fit_cost(
                fm, fdata, fobj, None, mesh_of(b, z)), (b, z))
    out = {}
    for name, (m, params, make, shape) in costs.items():
        cost = make()
        leaves = [t.detach().clone().requires_grad_(True) for t in params]
        collectives.sent.clear()
        f = cost(type(params)(*leaves))
        grads = torch.autograd.grad(f, leaves, allow_unused=True, materialize_grads=True)
        mesh = mesh_of(*shape)
        out[name] = {"f": f.detach(), "grads": torch.cat([g.reshape(-1) for g in grads]),
                     "sent": dict(collectives.sent), "cells": len(mesh.local(mesh.cells())),
                     "pupil_values": sum(t.numel() for t in m.plane_inputs(params))}
    return out


#: The unit-sum families of the fit evaluations and the blind round (:func:`family_scene`).
FAMILIES = ("confocal", "lightsheet")


def run_family_rounds(mesh_of) -> dict:
    """One round of the sharded blind loop of :func:`family_scene`'s confocal
    stack on (1, 4): the Wiener start, the object step and the joint fit,
    each on each cell's planes over the cells' one sum; with the bytes this
    rank sent by kind."""
    from microtipi_tpu_torch.parallel import collectives

    model, _, _, data = family_scene("confocal")
    cfg = BlindDeconvConfig(loops=1, skip_last_fit=False, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3),
                            joint_fit=True, init="wiener", deconv=DeconvolutionConfig(max_iter=4, **CFG))
    collectives.sent.clear()
    res = sharded_blind_deconvolve(data, model, mesh_of(1, 4), config=cfg)
    sent = dict(collectives.sent)
    return {"confocal_blind_1x4": {**_blind(res), "sent": sent}}


#: The object-step cases: one round (the Wiener start and the object step, no fit) of each sharded blind loop.
OBJECT_STEPS = ("blind_1x4", "blind_admm_1x4", "odd_2x2", "depthvar_blind_1x4")


def _planes(planes) -> list | str:
    """A ``psf_planes`` call's planes as a list of indices ("all": every plane)."""
    if isinstance(planes, slice):
        return "all" if planes == slice(None) else list(range(planes.start, planes.stop))
    return planes.tolist()


def run_object_steps(mesh_of) -> dict:
    """One round of each sharded blind loop of :data:`OBJECT_STEPS` (no fit:
    the Wiener start and the object step, each fed the PSF's cells'
    planes) on the meshes ``mesh_of(batch, z)`` makes: the object and
    ``deconv_f``, the bytes this rank sent by kind during the round, this
    rank's cells (z) and the planes of each ``psf_planes`` call on this rank
    (the last is the result's whole PSF)."""
    from microtipi_tpu_torch.parallel import collectives

    model, _, data, _ = scene()
    odd_model, odd = odd_scene()
    gl, _, _, ddata = depthvar_scene()
    one = dict(loops=1, families=(DEFOCUS, PHASE), psf_max_iter=(2, 2), joint_fit=True, init="wiener")
    deconv = DeconvolutionConfig(max_iter=4, **CFG)
    runs = {
        "blind_1x4": (model, (1, 4), lambda m, mesh: sharded_blind_deconvolve(
            data, m, mesh, config=BlindDeconvConfig(deconv=deconv, **one))),
        "blind_admm_1x4": (model, (1, 4), lambda m, mesh: sharded_blind_deconvolve(
            data, m, mesh, config=BlindDeconvConfig(deconv=deconv, deconv_engine="admm", **one))),
        "odd_2x2": (odd_model, (2, 2), lambda m, mesh: sharded_blind_deconvolve(
            odd, m, mesh, config=BlindDeconvConfig(deconv=DeconvolutionConfig(**ODD_CFG), **one))),
        "depthvar_blind_1x4": (gl, (1, 4), lambda m, mesh: sdv.sharded_blind_deconvolve_depthvar(
            ddata, m, mesh, ANCHORS, config=BlindDeconvConfig(deconv=DeconvolutionConfig(max_iter=4, **DV_CFG),
                                                              **one))),
    }
    out = {}
    for name, (m, shape, run) in runs.items():
        calls, plain = [], m.psf_planes

        def spy(inputs, planes=slice(None), **field):
            calls.append(_planes(planes))
            return plain(inputs, planes, **field)

        mesh = mesh_of(*shape)
        m.psf_planes = spy
        collectives.sent.clear()
        try:
            res = run(m, mesh)
        finally:
            del m.psf_planes
        sent = dict(collectives.sent)
        out[name] = {"obj": gather(res.obj), "deconv_f": res.deconv_f, "sent": sent, "calls": calls,
                     "cells": [z for _, z in mesh.local(mesh.volume_cells(False))]}
    return out


def one_process_mesh(batch: int, z: int):
    return make_mesh(batch, z, devices=[torch.device("cpu")] * (batch * z))


def child(rank: int, world: int, init: str, out: str, case: str) -> None:
    """Rank ``rank`` of ``world``: ``case`` "jobs" runs :func:`run_cases`,
    :func:`run_options`, :func:`run_solvers`, :func:`run_reductions` and
    :func:`run_slab_entries` and :func:`run_fit_evaluations` on meshes over
    the ranks and saves ``rank<r>.pt`` in ``out``; "few" runs :data:`FEW` of
    the cases and solvers, :data:`FEW_OPTIONS` of the options, the fit
    evaluations and :func:`run_family_rounds` ("jobs" also
    :func:`run_object_steps`); "fail"
    makes rank 1 raise before its first collective. A failure leaves its
    traceback in ``rank<r>.err`` and exits non-zero."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            if case == "fail" and rank == 1:
                raise RuntimeError("rank 1 fails before its first collective")

            def mesh_of(batch, z):
                return make_mesh(batch, z, devices=[torch.device("cpu")] * (batch * z // world),
                                 group=dist.group.WORLD)

            if case == "few":
                got = {**run_cases(mesh_of, FEW), **run_solvers(mesh_of, FEW), **run_options(mesh_of, FEW_OPTIONS)}
            else:
                got = {**run_cases(mesh_of), **run_options(mesh_of), **run_solvers(mesh_of)}
                got.update(reductions=run_reductions(mesh_of), slab_entries=run_slab_entries(mesh_of))
            got.update(fit_evaluations=run_fit_evaluations(mesh_of), family_rounds=run_family_rounds(mesh_of))
            if case != "few":
                got.update(object_steps=run_object_steps(mesh_of))
            torch.save(got, pathlib.Path(out) / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (pathlib.Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
