#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port, in turns, on one card.

    python3 scripts/torch_ab.py PARENT_DIR CHANGE_DIR [--rounds 2]

Runs the port's two main paths (the headline machine and rung 3, each on
its committed fixture's folded trace, chunk_steps from the fixture) to
completion through `Engine.run`, once per worker process, in the order
parent, change, change, parent for each round. Each worker imports
`primesim_tpu_torch` from its own directory (building that checkout's
kernels there), warms up on 64 steps, then times each whole path with the
host clock around `Engine.run` and a synchronise. Prints one JSON line per
worker (wall seconds and simulated MIPS per path) and a summary line with
each side's runs and medians. A worker fails if a path retires another
number of instructions than its trace holds.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

PATHS = ("headline", "rung3_headline")


def worker(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.kernels import build
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.trace.format import fold_ins

    build.build()
    out = {"root": root}
    for name in PATHS:
        with open(os.path.join(root, "primesim_tpu_torch", "fixtures", f"{name}.json")) as f:
            fx = json.load(f)
        spec = fx["config"]
        if isinstance(spec, str):
            with open(os.path.join(root, spec)) as f:
                spec = json.load(f)
        cfg = MachineConfig.from_dict(spec)
        tr = synth.GENERATORS[fx["trace"]["generator"]](**fx["trace"]["args"])
        tr = fold_ins(tr) if fx["trace"].get("fold") else tr
        Engine(cfg, tr, chunk_steps=64, device="cuda").run_steps(64)  # warm-up
        eng = Engine(cfg, tr, chunk_steps=fx["chunk_steps"], device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ins = int(eng.counters["instructions"].sum())
        if ins != tr.total_instructions():
            raise SystemExit(f"{root} {name}: {ins} instructions, trace has {tr.total_instructions()}")
        out[name] = {"steps": eng.steps_run, "wall_s": wall, "simulated_mips": ins / wall / 1e6}
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    parent, change = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 2
    runs = {"parent": [], "change": []}
    for _ in range(rounds):
        for side, root in (("parent", parent), ("change", change),
                           ("change", change), ("parent", parent)):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root],
                capture_output=True, text=True, timeout=900,
            )
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            line["side"] = side
            print(json.dumps(line), flush=True)
            runs[side].append(line)
    print(json.dumps({side: {p: {"wall_s": [r[p]["wall_s"] for r in rs],
                                 "median_mips": statistics.median(r[p]["simulated_mips"] for r in rs)}
                             for p in PATHS}
                      for side, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
