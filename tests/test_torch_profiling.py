"""The port's spans (``utils/profiling.span``) and its FFT counter
(``ops/convolution.fft_calls``) on the CPU at 8x16x16: no profiler, no
``RecordFunction``; under one, ``admm_deconvolve`` records each declared span
as often as its solve runs it, nested in the span that caused it; and the
counter counts a solve's fixed transforms and its iterations' own."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from microtipi_tpu_torch.jobs.admm import admm_deconvolve
from microtipi_tpu_torch.jobs.batch import batched_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.ops import convolution as conv
from microtipi_tpu_torch.utils import profiling

SHAPE = (8, 16, 16)
ITERS = 3


def _problem(lanes=None):
    g = torch.Generator().manual_seed(0)
    shape = SHAPE if lanes is None else (lanes,) + SHAPE
    data = 100.0 * torch.rand(shape, generator=g, dtype=torch.float64)
    psf = torch.rand(SHAPE, generator=g, dtype=torch.float64) ** 8
    weights = 0.5 + torch.rand(shape, generator=g, dtype=torch.float64)
    return data, psf / psf.sum(), weights


def _config(iters=ITERS):
    return DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=iters, grtol=0.0, gatol=0.0)


def _spans(run):
    """The span events that ``run()`` records under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [e for e in prof.events() if e.name in profiling.SPAN_NAMES]


def _counts(spans):
    return {n: sum(e.name == n for e in spans) for n in profiling.SPAN_NAMES}


def test_no_record_function_while_no_profiler_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction was made for {name!r}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("admm.solve") as a, profiling.span("admm.setup") as b:
        assert a is None and b is None
    data, psf, weights = _problem()
    admm_deconvolve(data, psf, weights=weights, config=_config(), track_objective=False)


def test_an_untracked_uniform_solve_records_each_span_nested_in_its_cause():
    data, psf, _ = _problem()
    spans = _spans(lambda: admm_deconvolve(data, psf, config=_config(), track_objective=False))
    assert _counts(spans) == {"admm.solve": 1, "admm.setup": 1, "admm.objective": 2, "admm.data_split": 0}
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None for e in spans if e.name != "admm.objective"}
    assert parent == {"admm.solve": None, "admm.setup": "admm.solve"}
    # slot 0 of f_history in the set-up, the final f in the solve
    assert sorted(e.cpu_parent.name for e in spans if e.name == "admm.objective") == ["admm.setup", "admm.solve"]


def test_a_weighted_solve_records_two_data_split_halves_an_iteration():
    data, psf, weights = _problem()
    spans = _spans(lambda: admm_deconvolve(data, psf, weights=weights, config=_config(), track_objective=False))
    split = [e for e in spans if e.name == "admm.data_split"]
    assert len(split) == 2 * ITERS
    assert all(e.cpu_parent.name == "admm.solve" for e in split)


def test_a_batched_solve_is_one_span():
    data, psf, _ = _problem(lanes=2)
    spans = _spans(lambda: batched_deconvolve(data, psf, config=_config(), engine="admm"))
    assert _counts(spans)["admm.solve"] == 1 and _counts(spans)["admm.setup"] == 1


# A solve's transforms, from jobs/admm.py and ops/convolution.py. Uniform: 5 in its set-up (UniformConvCost.build's
# kernel and data spectra and H^T d, the PSF spectrum again, the data spectrum again), 2 an objective value (slot 0
# and the final f), 2 an iteration. Weighted: 4 in its set-up (the cost's kernel spectrum, the PSF spectrum again,
# z0 = H x0), 2 an objective value, 4 an iteration (the data term's spectrum, H x, and x's pair).
@pytest.mark.parametrize("weighted,fixed,per_iteration", [(False, 5 + 2 * 2, 2), (True, 4 + 2 * 2, 4)])
@pytest.mark.parametrize("iters", [1, ITERS])
def test_fft_calls_counts_the_fixed_transforms_and_each_iterations(weighted, fixed, per_iteration, iters):
    data, psf, weights = _problem()
    conv.fft_calls = 0
    admm_deconvolve(data, psf, weights=weights if weighted else None, config=_config(iters), track_objective=False)
    assert conv.fft_calls == fixed + per_iteration * iters
