"""`python -m primesim_tpu_torch run`: one simulation through the port.

    python -m primesim_tpu_torch run configs/rung1_64core_fft.json \\
        --synth fft_like:n_phases=2 --fold --report report.txt

Simulates a trace (a PTPU file or a named synthetic generator) on a JSON
machine config, prints the one-line JSON summary of `primetpu run` and
optionally writes the same text report. It runs on the card unless
`--device cpu` is given. `--fault-schedule FILE [--fault-seed N]` arms
fault injection as `primetpu run` does (DESIGN.md §12); a malformed
schedule or config exits 2 with one `{"error": {type, location, detail}}`
JSON line on stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from .config.machine import ConfigError, FaultConfigError, MachineConfig
from .trace import synth
from .trace.format import Trace, TraceError, fold_ins


def _parse_synth(spec: str, n_cores: int, fold: bool) -> Trace:
    name, _, args = spec.partition(":")
    if name not in synth.GENERATORS:
        raise SystemExit(
            f"unknown generator {name!r}; have: {', '.join(sorted(synth.GENERATORS))}"
        )
    kw = {}
    for pair in filter(None, args.split(",")):
        k, eq, v = pair.partition("=")
        if not eq or not k:
            raise SystemExit(f"bad synth arg {pair!r} (want key=value)")
        try:
            kw[k] = int(v)
        except ValueError:
            raise SystemExit(
                f"bad synth arg {pair!r}: value must be an integer"
            ) from None
    try:
        tr = synth.GENERATORS[name](n_cores, **kw)
    except TypeError as e:
        raise SystemExit(f"synth {name!r}: {e}") from None
    return fold_ins(tr) if fold else tr


def _apply_faults(ns, cfg: MachineConfig) -> MachineConfig:
    """--fault-schedule installs a schedule (and --fault-seed its seed, 0
    by default); a bare --fault-seed needs a config that arms faults."""
    if ns.fault_schedule:
        from .faults.schedule import load_schedule

        return load_schedule(ns.fault_schedule).apply(cfg, seed=ns.fault_seed or 0)
    if ns.fault_seed is not None:
        if not cfg.faults_enabled:
            raise SystemExit(
                "--fault-seed without --fault-schedule needs a config with "
                "faults_enabled (the seed only feeds an armed fault model)"
            )
        return dataclasses.replace(cfg, fault_seed=ns.fault_seed)
    return cfg


def cmd_run(ns) -> int:
    from .kernels import build
    from .sim.engine import Engine, resolve_device
    from .stats.report import write_report

    if not ns.config.endswith(".json"):
        raise SystemExit("run: the port loads JSON machine configs only")
    with open(ns.config) as f:
        cfg = _apply_faults(ns, MachineConfig.from_json(f.read()))
    if ns.trace:
        tr = Trace.load(ns.trace)
        tr = fold_ins(tr) if ns.fold else tr
    elif ns.synth:
        tr = _parse_synth(ns.synth, cfg.n_cores, ns.fold)
    else:
        raise SystemExit("run: need --trace FILE or --synth SPEC")
    if tr.n_cores != cfg.n_cores:
        raise SystemExit(
            f"trace has {tr.n_cores} cores but config has {cfg.n_cores}"
        )
    device = resolve_device(ns.device)
    if device.type == "cuda":
        for k in build.KERNELS:  # build and load before the clock starts
            build.library(k)
    eng = Engine(cfg, tr, chunk_steps=ns.chunk_steps, device=device)
    t0 = time.perf_counter()
    eng.run(max_steps=ns.max_steps or 10_000_000)
    wall = time.perf_counter() - t0
    cycles, counters = eng.cycles, eng.counters
    tot_ins = int(counters["instructions"].sum())
    detail = {
        "engine": "torch",
        "device": str(device),
        "n_cores": cfg.n_cores,
        "instructions": tot_ins,
        "max_core_cycles": int(max(cycles)),
        "wall_s": round(wall, 3),
        "noc_msgs": int(counters["noc_msgs"].sum()),
        "steps": eng.steps_run,
    }
    print(json.dumps({
        "metric": "simulated_MIPS",
        "value": round(tot_ins / wall / 1e6, 3),
        "unit": "MIPS",
        "detail": detail,
    }))
    if ns.report:
        write_report(ns.report, cfg, counters, cycles, wall_s=wall)
        print(f"report written to {ns.report}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m primesim_tpu_torch",
        description="manycore simulator, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="simulate a trace on a machine config")
    r.add_argument("config", help="machine config (.json)")
    src = r.add_mutually_exclusive_group()
    src.add_argument("--trace", help="PTPU trace file")
    src.add_argument("--synth", help="synthetic workload spec name[:k=v,...]")
    r.add_argument(
        "--fold", action="store_true", help="fold INS batches into pre fields"
    )
    r.add_argument("--chunk-steps", type=int, default=256)
    r.add_argument("--max-steps", type=int, default=None)
    r.add_argument("--report", help="write the text report to this path")
    r.add_argument(
        "--fault-schedule", metavar="FILE",
        help="JSON fault schedule (events, flip and DUE rates, policies); "
             "arms the deterministic fault model (DESIGN.md §12)",
    )
    r.add_argument(
        "--fault-seed", type=int, default=None, metavar="N",
        help="seed of the counter-based fault PRNG (default 0)",
    )
    r.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="default: cuda (an error when there is no card)",
    )
    r.set_defaults(fn=cmd_run)
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    try:
        return ns.fn(ns)
    except (TraceError, ConfigError, FaultConfigError) as e:
        # typed errors exit 2 with ONE structured JSON line on stderr, as
        # `primetpu` prints them
        locate = getattr(e, "location", None)
        print(json.dumps({"error": {
            "type": type(e).__name__,
            "location": dict(locate()) if callable(locate) else {},
            "detail": str(e),
        }}), file=sys.stderr)
        return 2
