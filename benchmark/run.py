#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number the check compared beside its limit); the last
lines of standard error repeat the checks. With ``--trace 0`` the metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
The run exits non-zero, printing no result, without a card, with fewer
cards than the cell asks for, or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Caches stay in the checkout, at fixed paths; the kernels build into
    # microtipi_tpu_torch/_build/ beside their sources.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark.cell import forbidden_modules, run_cell

    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"refused: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
