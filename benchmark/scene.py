"""The scene a cell restores, made on the device from ``--seed``.

Rewritten from the port's ``utils/phantoms.py`` (``shells_phantom``,
``filaments_phantom``, ``apply_camera``) so that it runs on the card in a few
large calls: an extended, low-contrast embryo rather than sparse beads. Each
channel's object is a sum of structures, in physical units on the
configuration's grid:

- the embryo: an ellipsoid filled with a dim cytoplasm whose brightness
  varies smoothly (low-pass filtered noise);
- nuclei: spherical shells (a nuclear envelope) or filled spheres
  (chromatin), placed inside the embryo;
- filaments: persistent random walks with a Gaussian cross-section.

The stack is the object convolved with the channel's true PSF (the
reference's synthesis in float64, embedded in the stack's grid as the port
embeds its PSF), with Poisson shot noise and Gaussian read noise in ADU,
offset removed. The true PSF is also the calibrated PSF the non-blind
cells are given. Every random number comes from a ``torch.Generator`` on the
device seeded from ``(seed, stack, channel)``, so the same seed gives the
same stacks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.objective import pad_kernel
from benchmark.reference.precision import Precision
from benchmark.reference.psf import WideField

__all__ = ["Stack", "channel_model", "make_stack", "rng"]

F64 = Precision("float64")


class Stack(NamedTuple):
    """One stack to restore: ``data`` (Nz, Ny, Nx), or (C, Nz, Ny, Nx) for a
    multichannel configuration; ``truth`` the clean object in the data's
    units; ``psf`` the true (calibrated) PSF on the PSF grid, float32, one a
    channel; ``weights`` the data's per-voxel weights where the traffic
    restores with a noise model, else None."""

    index: int
    data: torch.Tensor
    truth: torch.Tensor
    psf: torch.Tensor
    weights: torch.Tensor | None = None


def inverse_variance(data: torch.Tensor, camera: dict) -> torch.Tensor:
    """The camera's inverse variance in ADU^-2, the data as the predictor of
    the shot noise: ``1 / (read_noise^2 + max(d, 0) / gain)``."""
    return 1.0 / (camera["read_noise_adu"] ** 2 + torch.clamp_min(data, 0.0) / camera["gain"])


def rng(seed: int, *keys: int, device) -> torch.Generator:
    """A generator on ``device`` for the stream ``keys`` of ``seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 63), *keys]).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state) & ((1 << 63) - 1))
    return g


def channel_model(config: dict, channel: dict, device, precision: Precision = F64) -> WideField:
    """The reference PSF model of one channel on the configuration's PSF grid."""
    vz, vy, vx = config["voxel_m"]
    return WideField(config["psf_grid"], config["na"], channel["emission_m"], config["ni"], vx, vz,
                     config["n_phase"], config["n_modulus"], device, precision)


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def _coords(shape, voxel, device):
    return [(torch.arange(n, device=device, dtype=torch.float32) + 0.5) * (v * 1e6) for n, v in zip(shape, voxel)]


def _gaussian_blur(vol: torch.Tensor, sigma_um: float, voxel) -> torch.Tensor:
    shape = vol.shape
    spec = torch.fft.rfftn(vol)
    freqs = [torch.fft.fftfreq(n, d=v * 1e6, device=vol.device) for n, v in zip(shape[:2], voxel[:2])]
    freqs.append(torch.fft.rfftfreq(shape[2], d=voxel[2] * 1e6, device=vol.device))
    k2 = freqs[0][:, None, None] ** 2 + freqs[1][None, :, None] ** 2 + freqs[2][None, None, :] ** 2
    return torch.fft.irfftn(spec * torch.exp(-2.0 * math.pi ** 2 * sigma_um ** 2 * k2), s=shape)


def _embryo(shape, voxel, s: dict, g, device):
    """(mask-weighted cytoplasm, centre, semi-axes) of the embryo ellipsoid."""
    z, y, x = _coords(shape, voxel, device)
    ext = [n * v * 1e6 for n, v in zip(shape, voxel)]
    centre = [e / 2 for e in ext]
    axes = [f * e / 2 for f, e in zip(s["embryo_fill"], ext)]
    r2 = (((z - centre[0]) / axes[0]) ** 2)[:, None, None] + (((y - centre[1]) / axes[1]) ** 2)[None, :, None] \
        + (((x - centre[2]) / axes[2]) ** 2)[None, None, :]
    inside = torch.sigmoid((1.0 - r2) * 20.0)
    texture = _gaussian_blur(torch.randn(shape, generator=g, device=device), s["cytoplasm_grain_um"], voxel)
    texture = 1.0 + s["cytoplasm_texture"] * texture / texture.std()
    return inside * torch.clamp_min(texture, 0.0), centre, axes


def _nuclei(shape, voxel, s: dict, filled: bool, centre, axes, g, device) -> torch.Tensor:
    z, y, x = _coords(shape, voxel, device)
    vol = torch.zeros(shape, device=device)
    n = s["nuclei"]
    radii = _uniform(g, n, *s["nucleus_radius_um"], device)
    amps = _uniform(g, n, 0.6, 1.0, device)
    # centres uniformly inside the embryo, at least one radius from its surface
    u = torch.randn(n, 3, generator=g, device=device, dtype=torch.float64)
    u = u / u.norm(dim=1, keepdim=True) * _uniform(g, n, 0.0, 1.0, device)[:, None] ** (1 / 3)
    for i in range(n):
        r = float(radii[i])
        c = [centre[a] + float(u[i, a]) * max(axes[a] - r, 0.0) for a in range(3)]
        sl = [slice(max(int((c[a] - r - 1) / (voxel[a] * 1e6)), 0), int((c[a] + r + 1) / (voxel[a] * 1e6)) + 1)
              for a in range(3)]
        dist = torch.sqrt(((z[sl[0]] - c[0]) ** 2)[:, None, None] + ((y[sl[1]] - c[1]) ** 2)[None, :, None]
                          + ((x[sl[2]] - c[2]) ** 2)[None, None, :])
        if filled:
            shell = torch.sigmoid((r - dist) / 0.1)
        else:
            shell = torch.exp(-0.5 * ((dist - r) / s["shell_um"]) ** 2)
        vol[sl[0], sl[1], sl[2]] += float(amps[i]) * shell
    return vol


def _filaments(shape, voxel, s: dict, centre, axes, g, device) -> torch.Tensor:
    n, steps, step_um = s["filaments"], s["filament_steps"], s["filament_step_um"]
    ext = torch.tensor([sh * v * 1e6 for sh, v in zip(shape, voxel)], device=device, dtype=torch.float64)
    cen = torch.tensor(centre, device=device, dtype=torch.float64)
    ax = torch.tensor(axes, device=device, dtype=torch.float64)
    pos = cen + 0.8 * ax * (2 * torch.rand(n, 3, generator=g, device=device, dtype=torch.float64) - 1)
    d = torch.randn(n, 3, generator=g, device=device, dtype=torch.float64)
    d = d / d.norm(dim=1, keepdim=True)
    kicks = torch.randn(steps, n, 3, generator=g, device=device, dtype=torch.float64)
    amps = _uniform(g, n, 0.5, 1.0, device)
    pts = []
    for k in range(steps):  # a persistent walk, reflected at the field's walls
        d = s["stiffness"] * d + (1 - s["stiffness"]) * kicks[k]
        d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-9)
        pos = pos + step_um * d
        lo, hi = pos < 0.5, pos > ext - 0.5
        d = torch.where(lo | hi, -d, d)
        pos = torch.minimum(torch.maximum(pos, torch.full_like(pos, 0.5)), ext - 0.5)
        pts.append(pos)
    pts = torch.stack(pts)  # (steps, n, 3)
    vox = torch.tensor(voxel, device=device, dtype=torch.float64) * 1e6
    idx = torch.clamp((pts / vox).long(), min=torch.zeros(3, dtype=torch.long, device=device),
                      max=torch.tensor(shape, device=device) - 1)
    flat = (idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]
    vol = torch.zeros(math.prod(shape), device=device)
    vol.index_add_(0, flat.reshape(-1), amps.float().repeat(steps) * (step_um / s["filament_sigma_um"]))
    vol = _gaussian_blur(vol.reshape(shape), s["filament_sigma_um"], voxel)
    return torch.clamp_min(vol, 0.0) / max(float(vol.max()), 1e-12) if n else vol


def true_params(model: WideField, config: dict, g) -> dict:
    """The channel's aberration: the first phase modes (Noll 4 on, defocus
    first) drawn from the seed; defocus and modulus nominal."""
    ab = config["aberration"]
    p = model.init_params()
    k = ab["modes"]
    p["phase"][:k] = _uniform(g, k, -ab["max_rad"], ab["max_rad"], model.device).to(p["phase"].dtype)
    return p


def make_stack(config: dict, seed: int, index: int, device, weights: str | None = None) -> Stack:
    """Stack ``index`` of the ring that ``seed`` draws; ``weights`` names its
    noise model (``"inverse_variance"``) or None."""
    shape, voxel, s = tuple(config["grid"]), config["voxel_m"], config["scene"]
    channels = config["channels"]
    datas, truths, psfs = [], [], []
    g0 = rng(seed, index, 0, device=device)
    cyto, centre, axes = _embryo(shape, voxel, s, g0, device)
    parts = {"cytoplasm": cyto}
    for ci, ch in enumerate(channels):
        g = rng(seed, index, ci + 1, device=device)
        obj = torch.zeros(shape, device=device)
        for kind, weight in ch["structures"].items():
            if kind not in parts:
                gk = rng(seed, index, 100 + len(parts), device=device)
                if kind in ("shells", "nuclei_filled"):
                    parts[kind] = _nuclei(shape, voxel, s, kind == "nuclei_filled", centre, axes, gk, device)
                elif kind == "filaments":
                    parts[kind] = _filaments(shape, voxel, s, centre, axes, gk, device)
                else:
                    raise ValueError(f"unknown structure {kind!r}")
            obj += weight * parts[kind]
        model = channel_model(config, ch, device)
        p = true_params(model, config, g)
        psf = model.psf(p)
        blurred = torch.fft.irfftn(torch.fft.rfftn(obj.double()) * torch.fft.rfftn(pad_kernel(psf, shape)), s=shape)
        cam = config["camera"]
        scale = cam["photons_at_max"] / float(blurred.max())
        electrons = torch.poisson(torch.clamp_min(blurred * scale, 0.0).float(), generator=g)
        data = electrons / cam["gain"] + cam["read_noise_adu"] * torch.randn(shape, generator=g, device=device)
        datas.append(data.float().contiguous())
        truths.append((obj * (scale / cam["gain"])).float())
        psfs.append(psf.float().contiguous())
        del blurred, electrons, data, psf
    one = len(channels) == 1
    pick = (lambda t: t[0]) if one else torch.stack
    data = pick(datas)
    if weights not in (None, "inverse_variance"):
        raise ValueError(f"unknown weights {weights!r}")
    w = inverse_variance(data, config["camera"]) if weights else None
    return Stack(index, data, pick(truths), pick(psfs), w)
