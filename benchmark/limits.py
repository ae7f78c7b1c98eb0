#!/usr/bin/env python3
"""Read the numbers ``correct`` compares, on many seeds, for setting limits.

    python3 benchmark/limits.py --workload <cell> --seeds 1 2 ... [--engine program|bfloat16|float32] [--out FILE]
    python3 benchmark/limits.py --config <config> --traffic <mix> --seeds ...

For each seed it makes the cell's first stack, restores it once with the
engine (the port's entry, as the window drives it, at the cell's own size;
or the plain reference in the program's place in ``bfloat16``, the control,
or in ``float32``), and prints one JSON line: the seed, the engine, the
unit's seconds and every reading of the entry's checker. The benchmark's
runs do not run this. ``limits/<cell>.json`` keeps the limits set from what
it reads: above the largest sound reading, below the control's smallest.
A configuration and a traffic mix that no cell pairs yet read the same way
by name.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--engine", default="program", choices=("program", "bfloat16", "float32"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import scene
    from benchmark.cell import load_cell, load_pair

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = load_cell(args.workload) if args.workload else load_pair(args.config, args.traffic)
    name = args.workload or f"{args.config}.{args.traffic}"
    config, traffic, entry, dev = spec["config"], spec["traffic"], spec["entry"], torch.device("cuda")
    if args.engine == "program":
        engine = entry.program(traffic, config, dev)
    else:
        engine = entry.reference(traffic, config, dev, args.engine)
    out = open(args.out, "a") if args.out else None
    warm = True
    for seed in args.seeds:
        stack = scene.make_stack(config, seed, 0, dev, traffic.get("weights"))
        if warm and args.engine == "program":
            engine.run(stack, warm=True)
            warm = False
        torch.cuda.synchronize()
        t = time.perf_counter()
        ans = engine.run(stack)
        torch.cuda.synchronize()
        unit_s = time.perf_counter() - t
        t = time.perf_counter()
        readings = entry.checker(traffic, config, dev).readings(stack, ans)
        torch.cuda.synchronize()
        line = json.dumps({"workload": name, "engine": args.engine, "seed": seed, "unit_s": unit_s,
                           "check_s": time.perf_counter() - t, "iterations": ans.iterations.tolist(),
                           "f": ans.f.tolist(), "readings": readings,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
        del stack, ans
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
