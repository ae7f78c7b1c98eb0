"""The port's command line against the JAX one, without running a solve.

- The help surface: every subcommand and option of
  ``tests/cli_help_snapshot.txt`` (the JAX CLI's pinned ``--help``, read and
  never written here) exists in the port's parser, and nothing else does;
  action by action, the port's options have the JAX parser's defaults,
  choices, nargs, types, metavars, required flags and help text. The named
  exceptions: the TPU-only ``--exact-fft`` / ``--no-exact-fft``, which the
  port drops, and two help strings that named the TPU runtime (``doctor``'s
  and ``watch --devices``'s).
- Config parity: for each argv line, the ``DeconvolutionConfig``,
  ``BlindDeconvConfig`` (with its ``PsfFitConfig``), PSF family config and
  preprocessing that the port's CLI builds equal, field by field, what the
  JAX CLI's ``_deconv_config``, ``_blind_config``, ``_build_model`` and
  ``_build_preprocess`` build from the same argv (the preprocessing's output
  on a seeded volume to 1e-6 of its largest value, both in float32).
- ``--mesh`` runs the sharded job on a mesh of CPU entries (it exited
  naming ``ROADMAP.md`` item 18 before the sharded paths were ported), and
  ``main()`` raises the card error when there is no card.
"""

import argparse
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from microtipi_tpu.cli import blind as jax_blind
from microtipi_tpu.cli import parser as jax_parser
from microtipi_tpu.cli import shared as jax_shared
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.cli import blind as tblind
from microtipi_tpu_torch.cli import main
from microtipi_tpu_torch.cli import shared as tshared
from microtipi_tpu_torch.cli.parser import build_parser
from microtipi_tpu_torch.io.tiffstack import write_stack

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cli_help_snapshot.txt")
#: The TPU-only flags the port drops (microtipi_tpu_torch/cli/shared.py docstring).
DROPPED = {"--exact-fft", "--no-exact-fft"}
#: Help strings that named the TPU runtime; the port's name the card.
HELP_CHANGED = {("doctor", None), ("watch", "devices")}
COMMANDS = ["doctor", "info", "psf", "fitpsf", "deconv", "blind", "simulate", "register", "deskew", "fsc",
            "fuse", "ism", "sim", "watch"]


class _Parsed(Exception):
    pass


def _jax_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser, caught as ``main`` calls ``parse_args``."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        if self.prog == "microtipi_tpu":
            raise _Parsed(self)
        return real(self, *a, **k)

    argparse.ArgumentParser.parse_args = catch
    try:
        jax_parser.main(["doctor"])
    except _Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the JAX main never parsed")


def _subparsers(ap):
    action = next(a for a in ap._actions if isinstance(a, argparse._SubParsersAction))
    return action


def _jax_args(argv):
    """The namespace the JAX CLI builds from ``argv``, without running it."""
    captured = {}
    saved = {}
    for name in dir(jax_parser):
        if name.startswith("cmd_"):
            saved[name] = getattr(jax_parser, name)
            setattr(jax_parser, name, lambda a: captured.setdefault("args", a))
    try:
        jax_parser.main(argv)
    finally:
        for name, fn in saved.items():
            setattr(jax_parser, name, fn)
    return captured["args"]


def _snapshot_flags() -> dict:
    """{command: the option strings its help in the snapshot shows}."""
    with open(SNAPSHOT) as fh:
        parts = fh.read().split("\n" + "=" * 78 + "\n")
    flags = {}
    for part in parts[1:]:
        cmd = re.match(r"\$ microtipi_tpu (\S+) --help", part).group(1)
        usage = part.split("\n\n")[0]  # argparse wraps the usage between tokens
        flags[cmd] = set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", usage)) - {"--help"}
    return flags


def test_subcommands_match_the_snapshot():
    with open(SNAPSHOT) as fh:
        head = fh.read().split("\n" + "=" * 78 + "\n")[0]
    listed = re.search(r"\{([a-z,]+)\}", head).group(1).split(",")
    port = list(_subparsers(build_parser()).choices)
    assert listed == COMMANDS == port


@pytest.mark.parametrize("cmd", COMMANDS)
def test_options_match_the_snapshot(cmd):
    """Every option of the snapshot's ``cmd --help`` but the dropped two is the
    port's, and the port has no other."""
    sub = _subparsers(build_parser()).choices[cmd]
    port = {s for a in sub._actions for s in a.option_strings if s.startswith("--")} - {"--help"}
    assert port == _snapshot_flags()[cmd] - DROPPED


def _fields(action):
    t = action.type
    return dict(option_strings=action.option_strings, dest=action.dest, default=action.default,
                choices=action.choices, nargs=action.nargs, const=action.const, required=action.required,
                metavar=action.metavar, type=getattr(t, "__name__", t), kind=type(action).__name__,
                help=action.help)


@pytest.mark.parametrize("cmd", COMMANDS)
def test_actions_match_the_jax_parser(cmd):
    """Defaults, choices, nargs, types, metavars and help text, action by action
    and in order, with the dropped flags and the two changed help strings
    named."""
    jax_sub = _subparsers(_jax_parser()).choices[cmd]
    port_sub = _subparsers(build_parser()).choices[cmd]
    want = [_fields(a) for a in jax_sub._actions if not DROPPED & set(a.option_strings)]
    got = [_fields(a) for a in port_sub._actions]
    assert [w["dest"] for w in want] == [g["dest"] for g in got]
    for w, g in zip(want, got):
        if (cmd, w["dest"]) in HELP_CHANGED:
            w.pop("help"), g.pop("help")
        assert g == w, w["dest"]
    jax_help = {a.dest: a.help for a in _subparsers(_jax_parser())._choices_actions}
    port_help = {a.dest: a.help for a in _subparsers(build_parser())._choices_actions}
    if (cmd, None) not in HELP_CHANGED:
        assert port_help[cmd] == jax_help[cmd]


SHAPE = (16, 32, 32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_surface")
    rng = np.random.default_rng(0)
    paths = {}
    for name, vol in (("d", rng.random(SHAPE) * 100), ("p", rng.random(SHAPE)),
                      ("flat", 0.8 + 0.4 * rng.random(SHAPE)), ("dark", 5 * rng.random(SHAPE))):
        paths[name] = str(d / f"{name}.tif")
        write_stack(paths[name], vol.astype(np.float32), dxy=90e-9, dz=250e-9)
    return paths


CASES = {
    "deconv-defaults": ["deconv", "{d}", "--psf", "{p}", "--out", "o.tif"],
    "deconv-tolerances": ["deconv", "{d}", "--psf", "{p}", "--out", "o.tif", "--mu", "0.003", "--epsilon", "0.5",
                          "--iters", "7", "--grtol", "0", "--gatol", "1e-9", "--no-positivity", "--pad", "2"],
    "deconv-poisson-priors": ["deconv", "{d}", "--psf", "{p}", "--out", "o.tif", "--data-term", "poisson",
                              "--background", "3", "--sparsity", "0.1", "--sparsity-epsilon", "0.2",
                              "--hessian", "0.05"],
    "deconv-admm": ["deconv", "{d}", "--psf", "{p}", "--out", "o.tif", "--method", "admm", "--admm-reltol",
                    "1e-3", "--admm-abstol", "1e-4", "--na", "1.2", "--ni", "1.33", "--wavelength", "5.2e-7"],
    "deconv-preprocess": ["deconv", "{d}", "--psf", "{p}", "--out", "o.tif", "--hot-pixels", "5",
                          "--destripe", "x", "--destripe-sigma", "1.5", "--subtract-background", "4",
                          "--flat", "{flat}", "--dark", "{dark}"],
    "deconv-dark-destripe-y": ["deconv", "{d}", "--psf", "{p}", "--out", "o.tif", "--dark", "{dark}",
                               "--destripe", "y", "--destripe-protect", "2"],
    "blind-defaults": ["blind", "{d}", "--out", "o.tif"],
    "blind-quality": ["blind", "{d}", "--out", "o.tif", "--recipe", "quality", "--mu", "0.02", "--loops", "4"],
    "blind-schedule": ["blind", "{d}", "--out", "o.tif", "--families", "defocus", "phase", "modulus",
                       "--psf-iters", "7", "--phase-schedule", "2", "4", "6", "8", "8", "--pin-z4",
                       "--wiener-init", "--n-modulus", "3"],
    "blind-anchored-admm": ["blind", "{d}", "--out", "o.tif", "--joint-fit", "--mu-schedule", "0.1", "0.05",
                            "0.02", "--loops", "3", "--phase-prior", "0.01", "--bead-weight", "2",
                            "--deconv-engine", "admm", "--iters", "9"],
    "blind-gl-depth": ["blind", "{d}", "--out", "o.tif", "--model", "gl", "--ns", "1.36", "--depth", "2e-6",
                       "--families", "defocus", "phase", "depth", "--n-phase", "4"],
    "psf-confocal": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "confocal", "--wavelength-exc",
                     "488e-9", "--pinhole", "1e-7", "--n-phase", "4"],
    "psf-2p-radial": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "2p", "--radial"],
    "psf-vectorial": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "vectorial", "--n-modulus", "3"],
    "psf-lightsheet": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "lightsheet", "--sheet-na", "0.2",
                       "--no-sheet-divergence", "--wavelength-exc", "4.88e-7"],
    "psf-lattice": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "lightsheet", "--sheet-mode",
                    "lattice", "--lattice-ky=0.1,0.3", "--sheet-na-min", "0.3"],
    "psf-sted": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "sted", "--depletion", "bottle",
                 "--saturation", "5", "--wavelength-dep", "7.75e-7"],
    "psf-4pi": ["psf", "p.tif", "--shape", "16", "32", "32", "--model", "4pi", "--fourpi-type", "C",
                "--cavity-phase", "0.3"],
}


def _argv(case, files):
    return [a.format(**files) for a in CASES[case]]


def _both(case, files):
    argv = _argv(case, files)
    ja, ta = _jax_args(argv), build_parser().parse_args(argv)
    ta.device = torch.device("cpu")
    path = files["d"] if argv[0] != "psf" else None
    jax_shared._resolve_geometry(ja, path, log=lambda *a: None)
    tshared._resolve_geometry(ta, path, log=lambda *a: None)
    return ja, ta


@pytest.mark.parametrize("case", list(CASES))
def test_configs_match_the_jax_cli(case, files):
    """The configs each argv builds, field by field (``convert`` carries the
    JAX configs' fields into the port's classes; the TPU-only ``exact_fft``
    stays behind)."""
    ja, ta = _both(case, files)
    assert (ta.dxy, ta.dz, ta.wavelength) == (ja.dxy, ja.dz, ja.wavelength)
    port_model = tshared._build_model(ta, SHAPE)
    assert port_model == convert.family_config_from_fields(jax_shared._build_model(ja, SHAPE))
    if ta.cmd == "psf":
        return
    port_deconv = tshared._deconv_config(ta, SHAPE)
    assert port_deconv == convert.deconv_config_from_fields(jax_shared._deconv_config(ja, SHAPE))
    if ta.cmd == "blind":
        port_blind = tblind._blind_config(ta, SHAPE)
        jax_cfg = jax_blind._blind_config(ja, SHAPE)
        assert port_blind == convert.blind_config_from_fields(jax_cfg)
        assert dataclasses.asdict(port_blind.fit) == {
            f.name: getattr(jax_cfg.fit, f.name) for f in dataclasses.fields(port_blind.fit)}
    jax_pre, port_pre = jax_shared._build_preprocess(ja), tshared._build_preprocess(ta)
    assert (jax_pre is None) == (port_pre is None)
    if port_pre is not None:
        vol = np.random.default_rng(1).random(SHAPE).astype(np.float32) * 100
        want, got = np.asarray(jax_pre(vol)), port_pre(vol)
        assert got.dtype == want.dtype == np.float32
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("cmd", ["deconv", "blind"])
def test_mesh_exits_naming_roadmap_item_18(cmd, files, tmp_path):
    """``--mesh`` runs its sharded job on a mesh of CPU entries and writes
    its output (``tests/test_torch_parallel_jobs.py`` holds the output to the
    job bit for bit). The name is that of the check this test replaced: the
    exit naming ROADMAP.md item 18, which the port no longer has."""
    argv = [cmd, files["d"], "--out", str(tmp_path / "o.tif"), "--mesh", "1", "2", "--iters", "2"]
    argv += ["--psf", files["p"]] if cmd == "deconv" else ["--loops", "2", "--psf-iters", "1"]
    main(argv, device="cpu")
    assert (tmp_path / "o.tif").exists()


def test_main_raises_without_a_card(monkeypatch, files):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["info", files["d"]])
    main(["info", files["d"]], device="cpu")
