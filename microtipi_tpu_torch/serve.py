"""Directory-watching batch service: continuous deconvolution of arriving stacks.

Port of ``microtipi_tpu/serve.py``. Production serving mode (nothing like it
exists in the reference — its ecosystem ran interactively inside Icy): watch
an input directory for new stacks (TIFF files, ``.zarr`` NGFF stores and
plates), deconvolve each with a fixed PSF/config or a blind loop, write
results to an output directory, and keep going. Host decode overlaps device
compute; one solver closure per (volume geometry, device) is built once and
reused across files.

Failure semantics (as the JAX service): files are claimed only once their
size is stable across scans; a file that errors is retried (it may have been
a partial write whose size happened to look stable) and only given up on
after ``max_retries`` attempts *at the same size* — a file that grows after a
failure is treated as new. Outputs are written atomically (tmp + rename) so
downstream watchers never see partial volumes. A vanishing input between
scan and claim is skipped, never fatal.

Pipelining: a small thread pool decodes the next ready stacks while the
device solves the current one. Observability: ``metrics_path`` atomically
maintains a JSON snapshot (counts, wall/compute seconds, throughput) after
every scan, and ``metrics_port`` serves the same snapshot over HTTP
(``GET /metrics``) from a daemon thread. Idle waiting uses Linux inotify when
available; the poll scan remains the source of truth.

What changes from the JAX service: the per-geometry ``jax.jit(...,
donate_argnums=0)`` solvers (``serve.py:340-434``) are closures cached per
(shape, device, calibration state) that hold what the geometry fixes (the
padded PSF, the synthesized anchors, the calibrated kernel), and ``devices``
is a list of ``torch.device``: by default the one CUDA card (an error when
there is none; no CPU fallback). With more than one entry, each file goes to
one device round-robin, one worker thread a device (``serve.py:658-701``).
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import json
import os
import select
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = ["watch"]

# ---- inotify-backed idle wait (Linux; falls back to plain sleep) -----------

_IN_EVENTS = 0x00000100 | 0x00000008 | 0x00000080 | 0x00000040  # CREATE|CLOSE_WRITE|MOVED_TO|MOVED_FROM


class _DirWaiter:
    """Sleep until the directory changes or ``timeout`` elapses
    (``serve.py:54-90``). The caller's scan loop is unchanged — this only
    decides how long the idle sleep lasts. ``close()`` releases the fd."""

    def __init__(self, path: Path):
        self._fd = None
        try:
            libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)
            fd = libc.inotify_init1(os.O_NONBLOCK)
            if fd < 0:
                return
            wd = libc.inotify_add_watch(fd, str(path).encode(), _IN_EVENTS)
            if wd < 0:
                os.close(fd)
                return
            self._fd = fd
        except Exception:
            self._fd = None  # any libc/platform oddity -> polling fallback

    def wait(self, timeout: float) -> None:
        if self._fd is None:
            time.sleep(timeout)
            return
        r, _, _ = select.select([self._fd], [], [], timeout)
        if r:
            try:  # drain the queue; events only end the sleep early
                os.read(self._fd, 65536)
            except OSError:
                pass

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


def _serve_metrics(port: int, snapshot):
    """Tiny HTTP endpoint (``serve.py:93-116``): GET /metrics -> the JSON
    snapshot. Returns the server (daemon-threaded); the caller shuts it down."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = json.dumps(snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: service logs go through `log`
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _tree_size(p: Path) -> int:
    """Total byte size of a directory store (zarr chunk files + metadata)."""
    total = 0
    for root, _dirs, files in os.walk(p):
        for f in files:
            try:
                total += os.stat(os.path.join(root, f)).st_size
            except OSError:
                pass
    return total


def _stable_files(indir: Path, seen: dict, exts=(".tif", ".tiff")) -> list[Path]:
    """Entries whose size is unchanged since the previous scan
    (``serve.py:131-152``). ``.zarr`` directory stores count too: their
    "size" is the recursive byte total, so a store still being chunk-written
    is held back exactly like a TIFF still being streamed."""
    ready = []
    for p in sorted(indir.iterdir()):
        try:
            if p.suffix.lower() == ".zarr" and p.is_dir():
                size = _tree_size(p)
            elif p.suffix.lower() in exts and p.is_file():
                size = p.stat().st_size
            else:
                continue
        except OSError:
            continue  # vanished or unreadable between iterdir and stat
        prev = seen.get(p.name)
        seen[p.name] = size
        if prev == size and size > 0:
            ready.append(p)
    return ready


def _devices(devices) -> list[torch.device]:
    """The serving devices: the one CUDA card by default (an error without
    one), else each entry as a ``torch.device``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("watch serves on the CUDA card by default and none is available; "
                               "pass devices=[torch.device('cpu')] to serve on the CPU")
        return [torch.device("cuda")]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices is empty")
    return devices


def _host_params(params):
    """A params tuple with every field as a CPU tensor (the calibration shared
    by every device)."""
    return type(params)(*(torch.as_tensor(v).detach().cpu() for v in params))


def _params_on(params, model):
    """``params`` on ``model``'s device at its dtype."""
    return type(params)(*(torch.as_tensor(v).to(device=model.device, dtype=model.dtype) for v in params))


def _params_text(params) -> dict:
    return {k: np.round(torch.as_tensor(v).numpy(), 5).tolist() for k, v in params._asdict().items()}


def watch(
    indir: str | os.PathLike,
    outdir: str | os.PathLike,
    psf_path: str | os.PathLike | None = None,
    config=None,
    method: str = "vmlmb",
    rl_iterations: int = 50,
    poll_seconds: float = 2.0,
    max_files: int | None = None,
    max_retries: int = 3,
    log=print,
    metrics_path: str | os.PathLike | None = None,
    prefetch: int = 2,
    metrics_port: int | None = None,
    model_factory=None,
    blind_config=None,
    channel: int = 0,
    timepoint: int = 0,
    devices=None,
    bead_path: str | os.PathLike | None = None,
    bead_n: int = 1,
    priority_patterns=None,
    zarr_levels: int = 1,
    preprocess=None,
    auto_mu: bool = False,
    auto_mu_tau: float = 1.0,
    auto_mu_sigma: float | None = None,
    auto_gain: bool = False,
    depthvar_k: int = 0,
    depthvar_params=None,
):
    """Run the service loop (``serve.py:155-718``). ``max_files`` bounds the
    run (None = forever). Returns the list of processed output paths.

    ``metrics_path`` maintains an atomic JSON metrics snapshot; ``prefetch``
    sizes the decode thread pool; ``metrics_port`` additionally serves the
    snapshot at ``http://127.0.0.1:<port>/metrics``.

    ``devices``: a list of ``torch.device`` (None: the CUDA card). With more
    than one, each stable file is dispatched to one of them round-robin, a
    worker thread per device — independent volumes need no cross-device
    communication. ``blind-once``, ``auto_mu`` and ``auto_gain`` calibrate on
    the first file alone before fanning out, so every device serves the same
    calibration. Given ``devices``, the metrics snapshot gains a
    ``per_device`` file count.

    Methods: ``vmlmb``/``rl``/``admm`` deconvolve every file with the fixed
    PSF from ``psf_path`` (``admm``: ``config.max_iter`` iterations a file,
    or Boyd stopping under ``config.admm_abstol``/``admm_reltol``).
    ``blind`` runs the full blind loop per file. ``blind-once`` blind-solves
    the first file, keeps the fitted pupil parameters (logged) and gives
    every later file the fast fixed-PSF solve with the calibrated PSF —
    parameters transfer across volume shapes because they live on the
    pupil, not the grid. Blind methods take ``model_factory(shape) -> PSF
    family config`` (the model is built on each device) and an optional
    ``blind_config`` instead of ``psf_path``.

    ``bead_path`` (with ``method="blind-once"``): calibrate the pupil once at
    startup from a bead stack (``fit_psf_beads``; ``bead_n > 1`` averages that
    many detected beads first) and serve every file on the fast path.

    ``auto_gain`` (``method="vmlmb"`` only): single-shot photon-transfer
    camera calibration on the first file; every solve then uses
    inverse-variance weights from its own data with the calibrated
    constants. ``auto_mu`` (``method="vmlmb"`` only): the first file's solve
    selects the TV weight by the Morozov discrepancy principle and later
    files reuse it on the fixed-mu solver.

    ``depthvar_k`` (``method="vmlmb"`` only): serve every file with the
    depth-varying solver, K anchor PSFs synthesized at each file's shape from
    ``model_factory(shape)`` (a Gibson-Lanni config) and ``depthvar_params``
    (None = the model's nominal parameters).

    OME hyperstack inputs are sliced at ``channel``/``timepoint``; NGFF
    plate stores are batches whose output plate mirrors the input layout.
    ``priority_patterns``: ``fnmatch`` filename patterns; within a scan,
    ready files matching an earlier pattern are processed first.
    """
    from microtipi_tpu_torch.io.tiffstack import read_stack, write_stack
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy
    from microtipi_tpu_torch.models import model_for
    from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

    blind = method in ("blind", "blind-once")
    if blind and model_factory is None:
        raise ValueError(f"method {method!r} needs model_factory(shape) -> model config")
    if depthvar_k:
        if method != "vmlmb":
            raise ValueError("depthvar_k rides the fixed-parameter VMLMB "
                             f"path; method {method!r} does not take it")
        if model_factory is None:
            raise ValueError("depthvar_k needs model_factory(shape) -> "
                             "Gibson-Lanni config (anchors vary its DEPTH family)")
        if auto_mu:
            raise ValueError("auto_mu does not take the depth-varying path "
                             "yet; calibrate mu offline (deconv --auto-mu)")
    if not blind and not depthvar_k and psf_path is None:
        raise ValueError(f"method {method!r} needs psf_path")
    if auto_mu and method != "vmlmb":
        raise ValueError("auto_mu calibrates the fixed-PSF VMLMB path; "
                         f"method {method!r} does not take it")
    if auto_gain and method != "vmlmb":
        raise ValueError("auto_gain builds variance weights for the VMLMB "
                         f"path; method {method!r} does not take it")
    if bead_path is not None and method != "blind-once":
        raise ValueError("bead_path requires method='blind-once'")
    per_device = devices is not None  # the JAX service counts per device when given devices
    devices = _devices(devices)

    indir, outdir = Path(indir), Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    psf = read_stack(psf_path) if psf_path is not None else None
    config = config or DeconvolutionConfig()

    solvers: dict[tuple, object] = {}
    solvers_lock = threading.Lock()
    calib = {"params": None}  # blind-once: fitted pupil parameters (CPU tensors)
    mu_calib = {"mu": None}   # auto_mu: mu from the first file's bisection
    gain_calib = {"gr": None}  # auto_gain: (gain, readout var) from file 1

    def _weights_of(d):
        # Per-file inverse-variance weights from the one-time photon-transfer
        # calibration, computed from each file's own data.
        if not auto_gain:
            return None
        from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

        g, rv = gain_calib["gr"]
        return InverseVarianceWeights(gain=g, readout_variance=rv).from_data(d)

    def _kernel(shape, device):
        return pad_fft_kernel(torch.as_tensor(psf, device=device), shape)

    def solver_for(shape, device):
        # The lock covers concurrent device workers racing the first build
        # of a shape's solver.
        calibrated = blind and calib["params"] is not None
        mu_done = auto_mu and mu_calib["mu"] is not None
        key = (shape, str(device), calibrated, mu_done)
        with solvers_lock:
            if key not in solvers:
                solvers[key] = _build_solver(shape, device, calibrated)
            return solvers[key]

    def _build_solver(shape, device, calibrated):
        if blind and not calibrated:
            from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve

            model = model_for(model_factory(shape), device)
            bcfg = blind_config or BlindDeconvConfig()

            def run(d):
                # Files arrive float32; the model's dtype governs the solve.
                res = blind_deconvolve(d.to(model.dtype), model, config=bcfg)
                return res.obj, res.params

            return run
        if blind:
            # blind-once, calibrated: fixed-PSF fast path with the pupil
            # synthesized at this shape from the fitted parameters.
            model = model_for(model_factory(shape), device)
            with torch.no_grad():
                kern = model.compute_psf(_params_on(calib["params"], model))
            return lambda d: deconvolve(d.to(model.dtype), kern, config=config).x
        if method == "rl":
            kern = _kernel(shape, device)
            return lambda d: richardson_lucy(d, kern, iterations=rl_iterations, mu=config.mu,
                                             epsilon=config.epsilon)
        if method == "admm":
            # config.max_iter iterations per file; config.admm_abstol /
            # admm_reltol make that a cap with Boyd §3.3 residual stopping.
            from microtipi_tpu_torch.jobs.admm import admm_deconvolve

            kern = _kernel(shape, device)
            return lambda d: admm_deconvolve(d, kern, weights=_weights_of(d), config=config,
                                             track_objective=False).x
        if depthvar_k:
            # Depth-varying serving: anchors synthesized at this shape from
            # the calibrated parameters (ladder or nominal).
            from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar, depth_anchor_psfs

            model = model_for(model_factory(shape), device)
            params = (_params_on(depthvar_params, model) if depthvar_params is not None
                      else model.init_params())
            if not hasattr(params, "depth"):
                raise ValueError("depthvar_k needs a model with a DEPTH "
                                 "family (models/gibson_lanni.py)")
            anchors = np.linspace(0.0, shape[0] - 1.0, depthvar_k)
            with torch.no_grad():
                psfs = depth_anchor_psfs(model, params, anchors, depth0=params.depth[1])
            return lambda d: deconvolve_depthvar(d.to(model.dtype), psfs, anchors, weights=_weights_of(d),
                                                 config=config).x
        if auto_mu and mu_calib["mu"] is None:
            # The first file calibrates mu by the discrepancy bisection
            # (jobs/autotune.py); later files reuse it on the fixed-mu
            # solver. The fan-out loop serializes until the calibration lands.
            from microtipi_tpu_torch.jobs.autotune import deconvolve_auto_mu

            kern = _kernel(shape, device)

            def run(d):
                res = deconvolve_auto_mu(d, kern, weights=_weights_of(d), config=config,
                                         sigma=auto_mu_sigma, tau=auto_mu_tau)
                return res.result.x, res.mu, res.sigma

            return run
        cfg = config
        if auto_mu:
            import dataclasses

            cfg = dataclasses.replace(config, mu=mu_calib["mu"])
        kern = _kernel(shape, device)
        return lambda d: deconvolve(d, kern, weights=_weights_of(d), config=cfg).x

    def solve(data):
        """One file on its device -> the output volume (handles the blind
        state machine)."""
        if auto_gain and gain_calib["gr"] is None:
            from microtipi_tpu_torch.weights.updaters import estimate_gain_readout

            g, rv = estimate_gain_readout(data)
            gain_calib["gr"] = (float(g), float(rv))
            log(f"[watch] calibrated camera from first file: gain="
                f"{float(g):.4g} e-/ADU, readout var {float(rv):.4g} ADU^2 "
                "(single-shot photon transfer)")
        out = solver_for(tuple(data.shape), data.device)(data)
        if blind and calib["params"] is None:
            obj, params = out
            if method == "blind-once":
                calib["params"] = _host_params(params)
                log(f"[watch] calibrated pupil from first file: {_params_text(calib['params'])}")
            return obj
        if blind and isinstance(out, tuple):
            return out[0]
        if auto_mu and isinstance(out, tuple):
            x, mu, sigma = out
            if mu_calib["mu"] is None:
                mu_calib["mu"] = float(mu)
                sig = float(sigma)
                sig_txt = ("weighted target" if sig != sig  # nan: weights set
                           else f"noise sigma {sig:.4g}")
                log(f"[watch] calibrated mu={float(mu):.4g} from first file "
                    f"({sig_txt}); later files use the fixed-mu solver")
            return x
        return out

    def _prep(v):
        # input preprocessing (flat/dark/hot-pixels/background), applied to
        # every decoded volume including the bead calibration stack
        return v if preprocess is None else np.asarray(preprocess(v))

    def _slice_tc(arr, name):
        nt, nc = arr.shape[:2]
        if nt == 1 and nc == 1:
            return _prep(np.ascontiguousarray(arr[0, 0]))
        t, c = min(timepoint, nt - 1), min(channel, nc - 1)
        log(f"[watch] {name}: hyperstack T={nt} C={nc}, using t={t} c={c}")
        return _prep(np.ascontiguousarray(arr[t, c]))

    def _decode(p):
        if str(p).lower().endswith(".zarr"):
            from microtipi_tpu_torch.io.plate import is_plate, list_plate_images, read_plate_image
            from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack

            if is_plate(p):
                # A dropped plate is a batch: decode every well/field; the
                # solve loop fans them through the per-shape solver and the
                # output mirrors the plate layout.
                items = {}
                for well, field in list_plate_images(p):
                    arr, _meta = read_plate_image(p, well, field)
                    items[(well, field)] = _slice_tc(arr, f"{Path(p).name}:{well}/{field}")
                return ("plate", items)
            arr, _meta = read_ngff_hyperstack(p)
        else:
            try:
                from microtipi_tpu_torch.io.ome import read_ome_hyperstack

                arr, _meta = read_ome_hyperstack(p)
            except Exception:
                return _prep(read_stack(p))
        return _slice_tc(arr, Path(p).name)

    if bead_path is not None:
        # Startup bead calibration: the same hyperstack/zarr-aware decode as
        # sample files, and the run's own family/budget/pin-Z4 settings from
        # blind_config so the bead produces the same pupil parameterization
        # the first-file path would.
        from microtipi_tpu_torch.jobs.psf_fit import average_beads, fit_psf_beads
        from microtipi_tpu_torch.models.microscope import DEPTH

        bead = torch.as_tensor(np.asarray(_decode(Path(bead_path))), device=devices[0])
        if bead_n > 1:
            bead, used = average_beads(bead, n_beads=bead_n)
            log(f"[watch] averaged {used} beads from {bead_path}")
        bcfg = blind_config
        fit_kw = {}
        if bcfg is not None:
            fit_kw = dict(
                families=tuple(f for f in bcfg.families if f != DEPTH),
                config=bcfg.fit,
                phase_freeze_head=bcfg.phase_freeze_head,
            )
        bead_model = model_for(model_factory(tuple(bead.shape)), devices[0])
        fit_res, _amp = fit_psf_beads(bead_model, bead.to(bead_model.dtype), **fit_kw)
        calib["params"] = _host_params(fit_res.params)
        log(f"[watch] calibrated pupil from bead stack {bead_path}: {_params_text(calib['params'])}")

    seen: dict[str, int] = {}
    done: set[tuple[str, int]] = set()  # (name, size): re-process if it grows
    attempts: dict[tuple[str, int], int] = {}
    processed: list[Path] = []
    stats = {
        "started_at": time.time(), "processed": 0, "failed_attempts": 0,
        "compute_seconds": 0.0, "voxels": 0, "scans": 0,
    }

    def snapshot():
        snap = dict(stats)
        wall = max(time.time() - snap.pop("started_at"), 1e-9)
        snap["uptime_seconds"] = round(wall, 3)
        snap["mvox_per_second"] = round(snap["voxels"] / wall / 1e6, 6)
        return snap

    def write_metrics():
        if metrics_path is None:
            return
        tmp = str(metrics_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot(), f)
        os.replace(tmp, str(metrics_path))

    pool = ThreadPoolExecutor(max_workers=max(1, prefetch))
    waiter = _DirWaiter(indir)
    http_srv = None
    if metrics_port is not None:
        http_srv = _serve_metrics(metrics_port, snapshot)
        log(f"[watch] metrics at http://127.0.0.1:{http_srv.server_address[1]}/metrics")
    state_lock = threading.Lock()
    fan_out = len(devices) > 1

    def _write_output(out, x, plate_wells=None, zarr_format=2):
        if plate_wells is not None or out.suffix.lower() == ".zarr":
            # Directory store: build aside, then swap atomically
            # (readers never see a half-written store).
            import shutil

            from microtipi_tpu_torch.io.plate import write_plate
            from microtipi_tpu_torch.io.zarrstack import write_ngff_hyperstack

            tmp = out.with_suffix(out.suffix + ".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            if plate_wells is not None:
                write_plate(tmp, plate_wells, zarr_format=zarr_format, levels=zarr_levels)
            else:
                write_ngff_hyperstack(tmp, x, levels=zarr_levels)
            if out.exists():
                shutil.rmtree(out)
            os.replace(tmp, out)
        else:
            tmp = out.with_suffix(out.suffix + ".tmp")
            write_stack(tmp, x)
            os.replace(tmp, out)

    def _done(key, out, dt, nvox, device):
        with state_lock:
            done.add(key)
            processed.append(out)
            stats["processed"] += 1
            stats["compute_seconds"] += dt
            stats["voxels"] += nvox
            if per_device:
                per = stats.setdefault("per_device", {})
                per[str(device)] = per.get(str(device), 0) + 1

    def _process_one(p, size, data_fut, device):
        key = (p.name, size)
        try:
            t0 = time.time()
            data = data_fut.result()
            scope = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
            with scope:
                if isinstance(data, tuple) and data[0] == "plate":
                    from microtipi_tpu_torch.io import zarr3

                    out_wells, nvox = {}, 0
                    for (well, field), vol in data[1].items():
                        x = solve(torch.as_tensor(vol, device=device)).cpu().numpy()
                        out_wells.setdefault(well, []).append(x)
                        nvox += int(x.size)
                    out = outdir / p.name
                    _write_output(out, None, plate_wells=out_wells,
                                  zarr_format=3 if zarr3.is_zarr3_group(p) else 2)
                    dt = time.time() - t0
                    _done(key, out, dt, nvox, device)
                    log(f"[watch] {p.name}: plate ({len(data[1])} images) done "
                        f"in {dt:.2f}s -> {out}")
                    return
                d = torch.as_tensor(data, device=device)
                shape = tuple(d.shape)
                x = solve(d).cpu().numpy()
            out = outdir / p.name
            _write_output(out, x)
            dt = time.time() - t0
            _done(key, out, dt, int(np.prod(shape)), device)
            tag = f" [{device}]" if per_device else ""
            log(f"[watch] {p.name}: {shape} done in {dt:.2f}s -> {out}{tag}")
        except Exception as e:  # keep serving; retry (bounded) next scan
            with state_lock:
                attempts[key] = attempts.get(key, 0) + 1
                n_att = attempts[key]
                stats["failed_attempts"] += 1
            log(
                f"[watch] {p.name}: FAILED attempt {n_att}/{max_retries} "
                f"({type(e).__name__}: {e})"
            )

    solver_pool = ThreadPoolExecutor(max_workers=len(devices)) if fan_out else None
    try:
        while max_files is None or len(processed) < max_files:
            ready = [
                p for p in _stable_files(indir, seen)
                if (p.name, seen[p.name]) not in done
                and attempts.get((p.name, seen[p.name]), 0) < max_retries
            ]
            if priority_patterns:
                import fnmatch

                def _rank(p):
                    for i, pat in enumerate(priority_patterns):
                        if fnmatch.fnmatch(p.name, pat):
                            return i
                    return len(priority_patterns)

                ready.sort(key=_rank)  # stable: name order within a rank
            stats["scans"] += 1
            if not ready:
                write_metrics()
                waiter.wait(poll_seconds)
                continue
            if max_files is not None:
                ready = ready[: max_files - len(processed)]
            # Decode ahead: file i+1 parses on host threads while the device
            # solves file i.
            futs = [(p, seen[p.name], pool.submit(_decode, p)) for p in ready]
            if solver_pool is not None:
                # Calibrate on one file before fanning out so every device
                # serves the same calibration; keep serializing while
                # uncalibrated (a failed first candidate must not make every
                # worker calibrate and race the write). method='blind' has
                # no shared calibration and fans out immediately.
                while ((method == "blind-once" and calib["params"] is None)
                       or (auto_mu and mu_calib["mu"] is None)
                       or (auto_gain and gain_calib["gr"] is None)) and futs:
                    p, size, fut = futs[0]
                    _process_one(p, size, fut, devices[0])
                    futs = futs[1:]
                tasks = [
                    solver_pool.submit(_process_one, p, size, fut, devices[i % len(devices)])
                    for i, (p, size, fut) in enumerate(futs)
                ]
                for t in tasks:
                    t.result()
            else:
                for p, size, fut in futs:
                    _process_one(p, size, fut, devices[0])
            write_metrics()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        if solver_pool is not None:
            solver_pool.shutdown(wait=False, cancel_futures=True)
        waiter.close()
        if http_srv is not None:
            http_srv.shutdown()
    return processed
