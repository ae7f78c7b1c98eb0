"""Mesh-sharded ADMM object engine.

Port of ``microtipi_tpu/parallel/admm.py``, the distributed
``jobs.admm.admm_deconvolve`` for one volume (Nz, Ny, Nx) z-sharded over the
mesh's z axis (row 0 of a mesh with several rows driven by one process;
every row's replica of it over processes, as JAX replicates it over the
batch axis):

- the x-update's circulant solve runs through the distributed transpose FFT
  (``parallel/fft.py``); its denominator ``rho0|H^|^2 + rho1 sum|D^|^2 +
  rho2`` lives in the y-sharded spectrum layout;
- the right-hand side ``rho1 D^T(z1 - u1) + rho2 (z2 - u2)`` and the split
  update (the hyperbolic prox, the positivity clamp, the dual updates) are
  the ADMM kernels' slab modes, one launch each a z-slab and an iteration,
  with the neighbouring slabs' planes: the previous slab's last ``z1_z``,
  ``u1_z`` plane for the rhs, the next slab's first ``x`` plane for the
  split update (around the ring, since the splitting is circular), whose z
  mask is the volume's last plane (GSPMD inserts these exchanges on a TPU);
  each kind of plane comes in one ``collectives.exchange`` an iteration,
  from the same rank or another;
- the data split's prox and dual update, the Boyd residual norms and the
  objective tracker are tile-by-tile PyTorch, every sum added in one order
  (``Mesh.add``), so every rank takes the Boyd test's branch alike.

The same objective as the dense engine (the masked prox makes it the
replicate-boundary ``make_objective`` exactly), so ``f`` and ``f_history``
compare across engines and paths. Scope as in the JAX module: Gaussian
(uniform or per-voxel weights) or Poisson data + mu * TV + positivity, no
padded variable, no batch, explicit ``rho*`` (no ``adaptive_rho``). The
split update writes its state in place, so every halo plane is a copy or a
received buffer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from microtipi_tpu_torch.jobs.admm import _admm_tolerances, _check_config, _grad_sq_spectrum, _scale_spectrum_
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult
from microtipi_tpu_torch.ops.kernels.admm_split import (
    admm_rhs_slab,
    admm_split_update_slab,
    slab_diffs,
    slab_diffs_adjoint,
)
from microtipi_tpu_torch.parallel.collectives import exchange
from microtipi_tpu_torch.parallel.deconv import _abs2, sharded_objective
from microtipi_tpu_torch.parallel.fft import sharded_irfftn, sharded_rfftn, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Z_AXIS, Mesh, ShardedVolume, send, shard

__all__ = ["sharded_admm_deconvolve"]


class _Slabs:
    """The z-slabs of the volume on this rank's cells (``local``, of
    ``cells``: the volume's) and the planes they read from the slab after or
    before them around the ring. Each call is one exchange with its moves
    listed alike on every rank: a plane from a cell of this rank is a copy,
    one from another rank's a received buffer."""

    def __init__(self, mesh: Mesh, nz: int):
        self.mesh, self.p = mesh, mesh.shape[Z_AXIS]
        self.cells = mesh.volume_cells(False)
        self.local = mesh.local(self.cells)
        self.nzs = nz // self.p

    def _planes(self, stacks, take, step: int) -> list[dict]:
        """Per dict of slab tensors in ``stacks`` (keyed by this rank's
        cells), each local cell's ``take`` of the tensor of the cell ``step``
        along its row's ring."""
        moves, mesh = [], self.mesh
        for k, s in enumerate(stacks):
            like = take(next(iter(s.values())))
            for b, z in self.cells:
                src, t = (b, (z + step) % self.p), None
                if src in s:
                    t = take(s[src])
                    t = send(t, mesh.device(b, z)) if mesh.is_local(b, z) else t
                moves.append((src, (b, z), t, like.shape, like.dtype, k))
        out = [{} for _ in stacks]
        for (_, dst, *_, k), t in zip(moves, exchange(mesh, [m[:5] for m in moves], "halo")):
            if t is not None:
                out[k][dst] = t
        return out

    def next_first(self, x: ShardedVolume) -> dict:
        """x's plane after each slab (around the ring), (1, Ny, Nx)."""
        return self._planes([x.tiles], lambda t: t[:1], 1)[0]

    def prev_last_z(self, *stacks: dict) -> list[dict]:
        """The z component of each (1, 3, nz, Ny, Nx) stack at the plane
        before each slab (around the ring), (1, Ny, Nx)."""
        return self._planes(stacks, lambda t: t[:, 0, -1], -1)

    def diffs(self, x: ShardedVolume) -> dict:
        """The circular differences of each slab (1, 3, nz, Ny, Nx)."""
        nxt = self.next_first(x)
        return {c: slab_diffs(x.tiles[c][None], nxt[c]) for c in self.local}

    def diffs_adjoint(self, g: dict, like: ShardedVolume) -> ShardedVolume:
        (prev,) = self.prev_last_z(g)
        return like.with_tiles({c: slab_diffs_adjoint(g[c], prev[c])[0] for c in self.local})


def _stack_norm(terms, mesh: Mesh) -> torch.Tensor:
    """The L2 norm of sharded volumes and dicts of slab stacks together, on
    the mesh's first device, every part added in one order (``Mesh.add``)."""
    cells = mesh.cells((0,))
    parts = [(t * t).sum() if isinstance(t, ShardedVolume) else
             mesh.add({c: (v * v).sum() for c, v in t.items()}, cells, next(iter(t.values())).dtype) for t in terms]
    return torch.sqrt(sum(parts[1:], parts[0]))


def sharded_admm_deconvolve(
    data,
    psf,
    mesh: Mesh,
    weights=None,
    x0=None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    rho0: float | None = None,
    rho1: float | None = None,
    rho2: float | None = None,
    over_relax: float = 1.8,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """The ADMM object step on the mesh (``admm.py:70-286``).

    ``data``, ``psf``: one volume (Nz, Ny, Nx) at the same grid, tensors or
    (data) a sharded volume; Nz and Ny divide the mesh's z axis. Parameters
    and defaults are ``jobs.admm.admm_deconvolve``'s; ``config.admm_abstol``
    / ``admm_reltol`` turn on the Boyd residual test every
    ``admm_check_every`` iterations. The result's ``x`` is a sharded volume.
    """
    _check_config(config, "admm")
    if len(data.shape) != 3:
        raise ValueError("sharded_admm_deconvolve takes one (Nz, Ny, Nx) volume; use the sharded VMLMB path "
                         "for batched axes")
    if tuple(psf.shape) != tuple(data.shape):
        raise ValueError("sharded mode requires psf shape == volume shape")
    data = shard(data, mesh, False)
    if weights is not None:
        # Zero weight excludes the voxel whatever its value: the prox reads
        # weights * data and the default x0 the raw data.
        weights = shard(weights, mesh, False)
        data = data.map(lambda d, w: torch.where(w > 0, d, torch.zeros_like(d)), weights)
    shape, dtype, first = tuple(data.shape), data.dtype, mesh.first
    mu, eps, bg, scales = float(config.mu), float(config.epsilon), float(config.background), config.scales
    poisson = config.data_term == "poisson"
    data_split = poisson or weights is not None
    r1 = float(rho1) if rho1 is not None else max(mu / max(eps, 1e-30), 1e-6)
    r2 = float(rho2) if rho2 is not None else r1
    n_el = float(np.prod(shape))
    if rho0 is not None:
        r0 = torch.tensor(float(rho0), dtype=dtype, device=first)
    elif poisson:  # Poisson curvature at the data scale: d/m^2 ~ 1/mean(m)
        r0 = 1.0 / torch.clamp_min(data.sum() / n_el + bg, 1e-12)
    elif weights is not None:
        r0 = weights.sum() / n_el
    al, n = float(over_relax), int(config.max_iter)
    slabs = _Slabs(mesh, shape[0])

    objective_fn, _ = sharded_objective(psf, data, weights, config, mesh, accurate=True)

    def objective(x):
        with torch.no_grad():
            return objective_fn(x)

    h_hat = sharded_spectrum(psf, mesh)
    h_conj = h_hat.map(torch.conj)
    s2 = shard(_grad_sq_spectrum(shape, scales, dtype), mesh, False, layout="y")
    den = s2 * r1 + r2
    inv_den = 1.0 / (den + (h_hat.map(_abs2) * r0 if data_split else h_hat.map(_abs2)))
    lanes = {c: torch.ones(1, dtype=dtype, device=mesh.device(*c)) for c in slabs.local}
    lam, rr1, rr2 = ({c: t * v for c, t in lanes.items()} for v in (mu / r1, r1, r2))

    x = shard(x0, mesh, False) if x0 is not None else data.map(
        lambda d: torch.clamp_min(d, 0.0) if config.positivity else d)
    x = x.map(lambda t: t.to(dtype).contiguous())
    hist = [objective(x)]
    st = {"x": x, "z1": slabs.diffs(x), "z2": x.map(torch.clone), "u2": x.map(torch.zeros_like)}
    st["u1"] = {c: torch.zeros_like(t) for c, t in st["z1"].items()}
    if data_split:
        st["z0"] = sharded_irfftn(h_hat * sharded_rfftn(x, mesh), shape, mesh)
        st["u0"] = x.map(torch.zeros_like)
        if not poisson:
            wd = weights * data
    else:
        htd_hat = h_conj * sharded_rfftn(data, mesh)

    def data_prox(v):
        if poisson:  # rho z^2 + z (1 + rho (b - v)) + (b - d - rho v b) = 0, the + root
            def root(vt, d, rr):
                b_coef = 1.0 + rr * (bg - vt)
                c_coef = bg - d - rr * vt * bg
                disc = torch.clamp_min(b_coef * b_coef - 4.0 * rr * c_coef, 0.0)
                return (-b_coef + torch.sqrt(disc)) / (2.0 * rr)

            return v.map(root, data, r0)
        return (wd + v * r0) / (weights + r0)

    def step():
        """One iteration; returns ``hx`` on the data-split paths."""
        z1_prev, u1_prev = slabs.prev_last_z(st["z1"], st["u1"])
        rhs = st["x"].with_tiles({
            c: admm_rhs_slab(st["z1"][c], st["u1"][c], st["z2"].tiles[c][None], st["u2"].tiles[c][None],
                             z1_prev[c], u1_prev[c], rr1[c], rr2[c], scales)[0]
            for c in slabs.local})
        x_hat = sharded_rfftn(rhs, mesh)
        if data_split:
            x_hat = x_hat + (h_conj * sharded_rfftn(st["z0"] - st["u0"], mesh)).map(_scale_spectrum_, r0)
        else:
            x_hat = x_hat + htd_hat
        x_hat = x_hat.map(_scale_spectrum_, inv_den)
        st["x"] = sharded_irfftn(x_hat, shape, mesh).map(torch.Tensor.contiguous)
        hx = None
        if data_split:
            hx = sharded_irfftn(h_hat * x_hat, shape, mesh)
            hxr = hx if al == 1.0 else al * hx + (1.0 - al) * st["z0"]
            z0 = data_prox(hxr + st["u0"])
            st["u0"] = st["u0"] + hxr - z0
            st["z0"] = z0
        x_next = slabs.next_first(st["x"])
        for c in slabs.local:
            admm_split_update_slab(st["x"].tiles[c][None], x_next[c], st["z1"][c], st["u1"][c],
                                   st["z2"].tiles[c][None], st["u2"].tiles[c][None], lam[c], eps, c[1] * slabs.nzs,
                                   shape[0], al, config.positivity, scales)
        return hx

    def converged(z_old, hx) -> bool:
        """Boyd section 3.3 (``jobs.admm._boyd_criterion``) on the mesh."""
        dx = slabs.diffs(st["x"])
        r_terms = [{c: dx[c] - st["z1"][c] for c in dx}, st["x"] - st["z2"]]
        z_terms = [st["z1"], st["z2"]]
        if data_split:
            r_terms.append(hx - st["z0"])
            z_terms.append(st["z0"])
        p_el = n_el * (4.0 + data_split)
        if not bool(_stack_norm(r_terms, mesh) <= math.sqrt(p_el) * abstol + reltol * _stack_norm(z_terms, mesh)):
            return False
        like = st["x"]
        dz1 = {c: st["z1"][c] - z_old["z1"][c] for c in dx}
        s_vec = slabs.diffs_adjoint(dz1, like) * r1 + (st["z2"] - z_old["z2"]) * r2
        aty = slabs.diffs_adjoint(st["u1"], like) * r1 + st["u2"] * r2
        if data_split:
            def conv_t(v):
                return sharded_irfftn(h_conj * sharded_rfftn(v, mesh), shape, mesh)

            s_vec = s_vec + conv_t(st["z0"] - z_old["z0"]) * r0
            aty = aty + conv_t(st["u0"]) * r0
        return bool(_stack_norm([s_vec], mesh) <= math.sqrt(n_el) * abstol + reltol * _stack_norm([aty], mesh))

    abstol, reltol, check_every, use_tol = _admm_tolerances(config)
    iterations, status = n, 1 if use_tol else 0
    for i in range(1, n + 1):
        check = use_tol and i % check_every == 0
        z_old = None
        if check:
            z_old = {"z1": {c: t.clone() for c, t in st["z1"].items()}, "z2": st["z2"].map(torch.clone)}
            if data_split:
                z_old["z0"] = st["z0"]
        hx = step()
        if track_objective:
            hist.append(objective(st["z2"]))
        if check and converged(z_old, hx):
            iterations, status = i, 0
            break
    out = st["z2"] if config.positivity else st["x"]
    f = objective(out).cpu().numpy()[()]
    f_history = np.full((n + 1,), np.nan, f.dtype)
    f_history[:len(hist)] = torch.stack([h.to(first) for h in hist]).cpu().numpy()
    return DeconvolutionResult(out, f, iterations, iterations, status, f_history, np.full_like(f_history, np.nan))
