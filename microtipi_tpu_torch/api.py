"""Stateful convenience API mirroring the reference's entry points.

Port of ``microtipi_tpu/api.py``. The functional core (``models``/``jobs``/
``optim``) is the way to drive the port; this module wraps it in stateful
classes whose shape follows the reference, so a microTiPi user finds every
name they know:

==========================  =================================================
reference                   here
==========================  =================================================
``WideFieldModel``          :class:`WideFieldModel` (setters/getters over a
                            ``models.widefield.WideFieldModel`` module)
``PSF_Estimation``          :class:`PSF_Estimation` (``fit_psf(flag)``,
                            tolerance/iteration setters, cost/iter getters)
``DeconvolutionJob``        :class:`DeconvolutionJob` (``update_psf`` /
                            ``deconv`` / ``get_model`` / ``abort``)
``BlindDeconvJob``          :class:`BlindDeconvJob` (``blind_deconv`` with
                            per-family budgets, cooperative abort between
                            rounds — ``BlindDeconvJob.java:112-132``)
``WeightUpdater``           ``weights.updaters.InverseVarianceWeights``
==========================  =================================================

Method names are snake_case Python; the mapping is 1:1 with the Java camelCase
(``computePsf -> compute_psf`` etc.). The port calls its functions eagerly:
the JAX module's jit caches have no counterpart. State lives on the card
unless a constructor is given another ``device`` (``"cpu"``); a constructor
raises when there is no card and none was named. Getters return NumPy arrays,
complex ones directly (the JAX module fetched real and imaginary parts apart
for a TPU runtime quirk).

Chunked dispatch (``abort_check_iters``, ``set_abort_check_iters``) keeps the
JAX module's semantics exactly: each slice is a whole solve of its own (the
L-BFGS memory restarts), ``abort`` takes effect between slices and never
inside one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult, deconvolve
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_psf
from microtipi_tpu_torch.models import widefield
from microtipi_tpu_torch.models.microscope import DEFOCUS, MODULUS, PHASE, family_name
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldParams
from microtipi_tpu_torch.ops.convolution import WeightedConvolutionCost
from microtipi_tpu_torch.utils.arrays import crop_to_shape, pad_fft_kernel

__all__ = [
    "WideFieldModel",
    "PSF_Estimation",
    "DeconvolutionJob",
    "BlindDeconvJob",
    "DEFOCUS",
    "PHASE",
    "MODULUS",
]


def _device(device, who: str) -> torch.device:
    """``device``, the card when None; raises if that is the card and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on the CUDA card by default and none is available; "
                           "pass device='cpu' to run it on the CPU")
    return device


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class WideFieldModel:
    """Stateful wide-field PSF model, reference-parity surface.

    Ctor signature mirrors ``WideFieldModel(psfShape, nPhase, nModulus, NA,
    lambda, ni, dxy, dz, radial, single)`` (``WideFieldModel.java:154-188``);
    ``psf_shape`` is ``(Nz, Ny, Nx)``; ``single`` float32, else float64. It
    wraps the port's ``models.widefield.WideFieldModel`` (:attr:`model`,
    an ``nn.Module`` on ``device``) and the current parameters.
    """

    def __init__(self, psf_shape, na, wavelength, ni, dxy, dz,
                 n_phase=0, n_modulus=1, radial=False, single=True, device=None):
        self._dtype = torch.float32 if single else torch.float64
        self._device = _device(device, "api.WideFieldModel")
        cfg = WideFieldConfig(
            shape=tuple(psf_shape), na=na, wavelength=wavelength, ni=ni,
            dxy=dxy, dz=dz, n_phase=n_phase, n_modulus=n_modulus,
            radial=radial, dtype=self._dtype,
        )
        self._model = widefield.WideFieldModel(cfg, self._device)
        self._params = self._model.init_params()

    # -- internals ---------------------------------------------------------

    @property
    def config(self) -> WideFieldConfig:
        return self._model.config

    @property
    def model(self) -> widefield.WideFieldModel:
        """The wrapped PSF module (what the functional jobs take)."""
        return self._model

    @property
    def params(self) -> WideFieldParams:
        return self._params

    @params.setter
    def params(self, p: WideFieldParams):
        self._params = p

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=self._dtype, device=self._device)

    def _rebuild(self, **changes):
        """Config change (mode-count resize): rebuild the basis and re-init
        ONLY the resized family, exactly like the reference —
        ``setNPhase`` zeroes the phase coefficients and leaves modulus alone
        (``WideFieldModel.java:1899-1914``); ``setNModulus`` re-inits modulus
        to [1, 0, ...] and leaves phase alone (``:1939-1961``)."""
        old = self._params
        self._model = widefield.WideFieldModel(dataclasses.replace(self.config, **changes), self._device)
        fresh = self._model.init_params()
        phase = fresh.phase if "n_phase" in changes else old.phase
        modulus = fresh.modulus if "n_modulus" in changes else old.modulus
        self._params = WideFieldParams(old.defocus, phase, modulus)

    # -- setters (setParam dispatch, WideFieldModel.java:411-422) -----------

    def set_param(self, flag: int, value):
        if flag == DEFOCUS:
            self.set_defocus(value)
        elif flag == PHASE:
            self.set_phase(value)
        elif flag == MODULUS:
            self.set_modulus(value)
        else:
            raise ValueError(f"unknown parameter flag {flag}")

    def set_defocus(self, defocus):
        """1, 2 or 3 values: {ni/lambda}, {dx, dy} or {ni/lambda, dx, dy}
        (``WideFieldModel.java:1510-1531``)."""
        d = self._tensor(defocus).ravel()
        cur = self._params.defocus
        if d.shape[0] == 3:
            new = d
        elif d.shape[0] == 1:
            new = torch.cat([d, cur[1:]])
        elif d.shape[0] == 2:
            new = torch.cat([cur[:1], d])
        else:
            raise ValueError("bad defocus parameters")
        self._params = self._params._replace(defocus=new)

    def set_phase(self, alpha):
        alpha = self._tensor(alpha).ravel()
        if alpha.shape[0] != self.config.n_phase:
            self._rebuild(n_phase=int(alpha.shape[0]))
        self._params = self._params._replace(phase=alpha)

    def set_modulus(self, beta):
        beta = self._tensor(beta).ravel()
        if beta.shape[0] != self.config.n_modulus:
            self._rebuild(n_modulus=int(beta.shape[0]))
        self._params = self._params._replace(modulus=beta)

    def set_ni(self, ni):
        self.set_defocus([ni / self.config.wavelength])

    def set_pupil_axis(self, axis):
        """{dx, dy}; one value sets both, as JAX's ``.at[1:].set`` broadcasts."""
        d = self._params.defocus
        self._params = self._params._replace(defocus=torch.cat([d[:1], self._tensor(axis).expand(2)]))

    def set_n_phase(self, n):
        self._rebuild(n_phase=int(n))

    def set_n_modulus(self, n):
        self._rebuild(n_modulus=int(n))

    # -- getters -------------------------------------------------------------

    def compute_psf(self) -> torch.Tensor:
        """PSF tensor (corner-origin) on the model's device."""
        with torch.no_grad():
            return self._model.compute_psf(self._params)

    def get_psf(self) -> np.ndarray:
        return _numpy(self.compute_psf())

    def get_mtf(self) -> np.ndarray:
        """3D FFT of the PSF, complex."""
        with torch.no_grad():
            return _numpy(self._model.compute_mtf(self._params))

    def get_cpx_psf(self) -> np.ndarray:
        """FFT of the pupil field per plane, complex. NOTE: the reference
        stores the *conjugate* (``WideFieldModel.java:254``); this returns the
        transform itself — conjugate at the call site if you need the legacy
        layout."""
        with torch.no_grad():
            return _numpy(self._model.compute_psf_and_field(self._params)[1])

    def _pupil(self):
        with torch.no_grad():
            return self._model.compute_pupil(self._params)

    def get_rho(self) -> np.ndarray:
        return _numpy(self._pupil()[0])

    def get_phi(self) -> np.ndarray:
        return _numpy(self._pupil()[1])

    def get_psi(self) -> np.ndarray:
        return _numpy(self._pupil()[2])

    def get_mask_pupil(self) -> np.ndarray:
        return _numpy(self._pupil()[3])

    def get_defocus(self) -> np.ndarray:
        return _numpy(self._params.defocus)

    def get_defocus_multiply_by_lambda(self) -> np.ndarray:
        return self.get_defocus() * self.config.wavelength

    def get_pupil_shift(self) -> np.ndarray:
        return _numpy(self._params.defocus[1:])

    def get_phase_coefs(self) -> np.ndarray:
        return _numpy(self._params.phase)

    def get_modulus_coefs(self) -> np.ndarray:
        return _numpy(self._params.modulus)

    def get_zernike(self, k: int | None = None) -> np.ndarray:
        z = _numpy(self._model.zernike)
        return z if k is None else z[k]

    def get_n_zern(self) -> int:
        return self.config.n_zern

    def get_n_phase(self) -> int:
        return self.config.n_phase

    def get_n_modulus(self) -> int:
        return self.config.n_modulus

    def get_lambda(self) -> float:
        return self.config.wavelength

    def get_ni(self) -> float:
        return float(self._params.defocus[0]) * self.config.wavelength

    def apply_jacobian(self, grad, flag: int) -> np.ndarray:
        """Adjoint of the PSF synthesis into one family's coefficient space —
        the reference's ``apply_Jacobian`` (``WideFieldModel.java:398-409``),
        as the gradient of ``vdot(q, psf)`` by autograd instead of 940
        hand-written lines."""
        family = family_name(flag)
        q = self._tensor(grad)
        leaf = getattr(self._params, family).detach().requires_grad_()
        psf = self._model.compute_psf(self._params._replace(**{family: leaf}))
        (g,) = torch.autograd.grad(torch.vdot(q.reshape(-1), psf.reshape(-1)), leaf)
        return _numpy(g)

    def get_info(self) -> str:
        """Statistics dump, equivalent of ``getInfo`` (``WideFieldModel.java:1866-1894``)."""
        rho, phi, psi, mask = (_numpy(a) for a in self._pupil())
        psf = self.get_psf()

        def stat(name, a):
            return f"{name}: min={a.min():.6g} max={a.max():.6g} mean={a.mean():.6g} std={a.std():.6g}"

        return "\n".join(
            [stat("PSF", psf), stat("PHI", phi), stat("RHO", rho), stat("PSI", psi),
             stat("MASK", mask), stat("ZERNIKES", self.get_zernike())]
        )

    def free_mem(self):
        """Reference-parity no-op: the PSF is recomputed from the parameters
        on every access, so there is no PState cache to free."""

    def compute_defocus(self):
        """Reference-parity no-op: psi and the evanescent mask are re-derived
        from the current defocus parameters on every access (pure functions),
        so the explicit recompute + invalidation the reference needs
        (``WideFieldModel.java:1452-1499,1532``) has nothing to do here."""

    def get_parameters_flags(self):
        """The canonical family order ``{DEFOCUS, PHASE, MODULUS}``
        (``WideFieldModel.java:123,1999-2002``; the abstract contract at
        ``MicroscopeModel.java:96``)."""
        return [DEFOCUS, PHASE, MODULUS]

    # Per-family adjoints, named like the reference's hand-written versions
    # (``WideFieldModel.java:429,738,1029``) — all three route through the
    # same autograd adjoint that replaces them.
    def apply_j_defocus(self, q):
        return self.apply_jacobian(q, DEFOCUS)

    def apply_j_phase(self, q):
        return self.apply_jacobian(q, PHASE)

    def apply_j_modulus(self, q):
        return self.apply_jacobian(q, MODULUS)


class PSF_Estimation:
    """PSF-parameter fitting, reference-parity surface
    (``microscopy/PSF_Estimation.java``). Data, object and weights live on
    the pupil's device in its dtype."""

    def __init__(self, pupil: WideFieldModel):
        if pupil is None:
            raise ValueError("pupil not specified")
        self.pupil = pupil
        self._data = None
        self._obj = None
        self._weights = None
        self._cfg = PsfFitConfig()
        self._fcost = 0.0
        self._iterations = 0
        self._evaluations = 0
        self._run = True
        self._debug = False
        self._lower_bound = float("-inf")
        self._upper_bound = float("inf")
        self._limited_memory_size = 5
        self._abort_k = None

    # setters mirroring PSF_Estimation.java:263-308,322-324,350,386
    def set_data(self, data):
        self._data = self.pupil._tensor(data)

    def set_obj(self, obj):
        self._obj = self.pupil._tensor(obj)

    def set_weight(self, weights):
        self._weights = None if weights is None else self.pupil._tensor(weights)

    def set_maximum_iterations(self, n):
        # maxeval = 2*maxiter, PSF_Estimation.java:270-273
        self._cfg = dataclasses.replace(self._cfg, max_iter=int(n), max_eval=2 * int(n))

    def set_absolute_tolerance(self, v):
        self._cfg = dataclasses.replace(self._cfg, gatol=float(v))

    def set_relative_tolerance(self, v):
        self._cfg = dataclasses.replace(self._cfg, grtol=float(v))

    def set_debug_mode(self, value):
        """Print per-fit cost traces (``PSF_Estimation.java:263-265``; the
        reference's ``debug`` prints inside the reverse-communication loop)."""
        self._debug = bool(value)

    def set_limited_memory_size(self, value):
        """Parity quirk: the reference's setter is dead — ``fitPSF`` forces
        ``limitedMemorySize = 0`` then defaults the VMLMB memory to 5
        (``PSF_Estimation.java:170,188,278-280``). Recorded, no effect."""
        self._limited_memory_size = int(value)

    def set_lower_bound(self, value):
        """Parity quirk: bounds feed the ``bounded`` bitmask but the
        projector stays ``null`` in PSF fitting
        (``PSF_Estimation.java:168-189,299-301``). Recorded, inert."""
        self._lower_bound = float(value)

    def set_upper_bound(self, value):
        """Inert like :meth:`set_lower_bound` (``PSF_Estimation.java:306-308``)."""
        self._upper_bound = float(value)

    def enable_positivity(self, flag):
        """``setLowerBound(positivity ? 0 : -inf)`` (``PSF_Estimation.java:94-96``);
        inert in the fit itself — same live behavior as the reference."""
        self.set_lower_bound(0.0 if flag else float("-inf"))

    def set_pupil(self, pupil: WideFieldModel):
        """Change the microscope model (``PSF_Estimation.java:329-331``)."""
        self.pupil = pupil

    def abort(self):
        self._run = False

    def set_abort_check_iters(self, k):
        """Bounded-latency abort: fit in ``k``-iteration slices with the
        parameters carried between them, so :meth:`abort` takes effect within
        k iterations — the reference's per-reverse-communication-iteration
        abort (``PSF_Estimation.java:200,313-315``) at k granularity.
        Semantics delta vs one solve: the L-BFGS memory restarts each slice
        and a nonzero ``grtol`` re-anchors on each slice's own initial
        gradient (slightly stricter; the blind loop's fits run grtol=0 where
        this is moot). ``None`` restores the single-solve default."""
        self._abort_k = None if k is None else int(k)

    def _fit(self, flag: int, config: PsfFitConfig):
        return fit_psf(self.pupil.model, self.pupil.params, flag, self._data, self._obj,
                       weights=self._weights, config=config)

    def fit_psf(self, flag: int):
        if self._data is None:
            raise ValueError("Input data not specified.")
        if self._obj is None:
            raise ValueError("Object not specified.")
        self._run = True
        if self._abort_k is None or int(self._cfg.max_iter) <= 0:
            res = self._fit(flag, self._cfg)
            self.pupil.params = res.params
            self._fcost = float(res.f)
            self._iterations = int(res.iterations)
            self._evaluations = int(res.evaluations)
        else:
            # Chunked: abort honored between k-iteration slices (see
            # set_abort_check_iters).
            total = int(self._cfg.max_iter)
            maxeval = (int(self._cfg.max_eval)
                       if self._cfg.max_eval is not None else 2 * total)
            done = evals = 0
            res = None
            while done < total and self._run:
                it = min(self._abort_k, total - done)
                cfg = dataclasses.replace(self._cfg, max_iter=it, max_eval=max(1, min(2 * it, maxeval - evals)))
                r = self._fit(flag, cfg)
                self.pupil.params = r.params
                done += int(r.iterations)
                evals += int(r.evaluations)
                res = r
                if int(r.iterations) < it or evals >= maxeval:
                    break
            self._fcost = float(res.f)
            self._iterations = done
            self._evaluations = evals
        if self._debug:
            hist = np.asarray(res.f_history)[: int(res.iterations) + 1]
            print(f"fit_psf(flag={flag}): f={self._fcost:.6g} "
                  f"iters={self._iterations} evals={self._evaluations} "
                  f"f_history={np.array2string(hist, precision=6)}")
        return res

    # getters (PSF_Estimation.java:336-396)
    def get_cost(self) -> float:
        return self._fcost

    def get_iterations(self) -> int:
        return self._iterations

    def get_evaluations(self) -> int:
        return self._evaluations

    def get_pupil(self) -> WideFieldModel:
        return self.pupil

    get_model = get_pupil

    def get_data(self):
        return self._data

    def get_psf(self):
        return self.pupil.compute_psf()

    def free_mem(self):
        self.pupil.free_mem()


class DeconvolutionJob:
    """Object-update solver, mirroring the TiPi ``DeconvolutionJob`` surface
    the reference drives (``BlindDeconvJob.java:103-108``)."""

    def __init__(self, data, psf=None, weights=None,
                 mu=0.01, epsilon=0.01, scales=None, positivity=True,
                 max_iter=50, grtol=1e-3, var_shape=None,
                 data_term="gaussian", background=0.0,
                 abort_check_iters=None, progress=None, device=None):
        """``data`` goes to ``device`` (the card when None) in its own
        dtype; the PSF and weights follow it.

        ``abort_check_iters``: when set to K, the solve runs in K-iteration
        slices with the object carried between them, so :meth:`abort` (from
        another thread, or from the ``progress`` callback) takes effect
        within K iterations instead of at the end of the whole ``max_iter``
        solve — the reference's per-iteration ``abort()`` semantics at K
        granularity (``PSF_Estimation.java:200,313-315``). Trade-off: each
        slice restarts the L-BFGS curvature memory, so keep K >= ~10; the
        stopping rule stays EXACT (the relative-gradient threshold is
        anchored on the first slice's initial gradient).
        ``progress(iters_done, f)`` is called after every slice."""
        self._data = torch.as_tensor(data, device=_device(device, "api.DeconvolutionJob"))
        self._weights = None if weights is None else self._tensor(weights)
        self._psf = None if psf is None else self._tensor(psf)
        self._cfg = DeconvolutionConfig(
            mu=mu, epsilon=epsilon, scales=scales, positivity=positivity,
            max_iter=max_iter, grtol=grtol, var_shape=var_shape,
            data_term=data_term, background=background,
        )
        self._result = None
        self._run = False
        self._abort_k = None if abort_check_iters is None else int(abort_check_iters)
        self._progress = progress

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=self._data.dtype, device=self._data.device)

    def update_psf(self, psf):
        """Accepts a *corner-origin* PSF. (The reference rolls to centered
        before TiPi's setPSF — our convolution consumes FFT layout directly;
        pass ``utils.arrays.unroll(psf)`` if yours is centered.)"""
        self._psf = self._tensor(psf)

    def update_weights(self, weights):
        self._weights = None if weights is None else self._tensor(weights)

    def _solve(self, cfg, obj) -> DeconvolutionResult:
        return deconvolve(self._data, self._psf, weights=self._weights, x0=obj, config=cfg)

    def deconv(self, obj=None):
        if self._psf is None:
            raise ValueError("PSF not set; call update_psf first")
        if obj is not None:
            obj = self._tensor(obj)
        self._run = True
        if self._abort_k is None:
            res = self._solve(self._cfg, obj)
            self._result = res
            self._run = False
            return res.x
        # Chunked (bounded-latency abort; see __init__). The relative-gradient
        # rule is anchored ONCE: slice 1 runs the configured (gatol, grtol);
        # its initial projected-gradient norm pg0 (pg_history[0]) converts
        # grtol to the absolute threshold max(gatol, grtol*pg0) that every
        # later slice runs with grtol=0 — exactly the single solve's gstop.
        k = self._abort_k
        total = int(self._cfg.max_iter)
        maxeval = (int(self._cfg.max_eval) if self._cfg.max_eval is not None
                   else 2 * total)
        done = 0
        evals = 0
        res = None
        hists_f, hists_pg = [], []
        gate = None
        while done < total and self._run:
            it = min(k, total - done)
            cfg = dataclasses.replace(
                self._cfg, max_iter=it,
                max_eval=max(1, min(2 * it, maxeval - evals)),
                gatol=self._cfg.gatol if gate is None else gate,
                grtol=self._cfg.grtol if gate is None else 0.0,
            )
            r = self._solve(cfg, obj)
            if gate is None:
                pg0 = float(np.asarray(r.pg_history)[0])
                gate = max(self._cfg.gatol, self._cfg.grtol * pg0)
            obj = r.x
            done += int(r.iterations)
            evals += int(r.evaluations)
            first = 0 if not hists_f else 1  # later slices repeat the previous slice's last value
            hists_f.append(np.asarray(r.f_history)[first: int(r.iterations) + 1])
            hists_pg.append(np.asarray(r.pg_history)[first: int(r.iterations) + 1])
            res = r
            if self._progress is not None:
                self._progress(done, float(r.f))
            if int(r.iterations) < it or evals >= maxeval:
                break  # converged / stalled / budget inside the slice
        hf = np.concatenate(hists_f) if hists_f else np.asarray([])
        hp = np.concatenate(hists_pg) if hists_pg else np.asarray([])
        pad = max(0, total + 1 - hf.size)
        self._result = res._replace(
            iterations=done, evaluations=evals,
            f_history=np.pad(hf, (0, pad), constant_values=np.nan),
            pg_history=np.pad(hp, (0, pad), constant_values=np.nan),
        )
        self._run = False
        return self._result.x

    def get_model(self):
        """Convolved current object H*x at the data window (TiPi
        ``getModel``, used by weight updaters), on the data's device."""
        if self._result is None:
            return None
        x = self._result.x
        with torch.no_grad():
            kern = pad_fft_kernel(self._psf, tuple(x.shape))
            return WeightedConvolutionCost.build(kern, self._data, None, tuple(x.shape)).model(x)

    def get_cost(self):
        return None if self._result is None else float(self._result.f)

    def is_running(self):
        return self._run

    def abort(self):
        self._run = False


class BlindDeconvJob:
    """Host-driven alternating loop with cooperative abort between rounds
    (``microUtils/BlindDeconvJob.java``). The functional loop is
    ``jobs.blind.blind_deconvolve`` (joint or sequential fits, a config)."""

    def __init__(self, loops, parameters_flags, max_iter, psf_estimation,
                 deconvolver, weight_updater=None, debug=False):
        if len(parameters_flags) != len(max_iter):
            raise ValueError("parameters_flags and max_iter must pair up")
        self.loops = int(loops)
        self.parameters_flags = tuple(parameters_flags)
        self.max_iter = tuple(max_iter)
        self.psf_estimation = psf_estimation
        self.deconvolver = deconvolver
        self.weight_updater = weight_updater
        self.debug = debug
        self._run = False
        self._psf = None

    def blind_deconv(self, obj):
        """The reference loop verbatim (``BlindDeconvJob.java:97-138``):
        deconv, optional weight update feeding the PSF step, per-family fits
        (skipped on the last round), abort checks between stages."""
        self._run = True
        obj = self.deconvolver._tensor(obj)
        for i in range(self.loops):
            self._psf = self.psf_estimation.get_psf()
            self.deconvolver.update_psf(self._psf)
            obj = self.deconvolver.deconv(obj)
            if self.weight_updater is not None:
                w = self.weight_updater.update(self.deconvolver.get_model(),
                                               self.deconvolver._data)
                self.psf_estimation.set_weight(w)
            if not self._run:
                return obj
            if i < self.loops - 1:
                data = self.psf_estimation._data
                data_shape = tuple(data.shape) if data is not None else tuple(obj.shape)
                obj_at_data = crop_to_shape(obj, data_shape) if tuple(obj.shape) != data_shape else obj
                self.psf_estimation.set_obj(obj_at_data)
                for j, flag in enumerate(self.parameters_flags):
                    if self.debug:
                        print(f"------ family {flag} estimation ------")
                    self.psf_estimation.set_relative_tolerance(0.0)
                    self.psf_estimation.set_maximum_iterations(self.max_iter[j])
                    if self.max_iter[j] > 0:
                        self.psf_estimation.fit_psf(flag)
                    if not self._run:
                        return obj
        self._run = False
        return obj

    def is_running(self):
        return self._run

    def abort(self):
        self._run = False
        self.deconvolver.abort()
        self.psf_estimation.abort()

    def get_psf(self):
        return self._psf

    def get_pupil(self):
        return self.psf_estimation.get_pupil()

    def get_model(self):
        return self.deconvolver.get_model()

    def get_deconvolver(self):
        return self.deconvolver
