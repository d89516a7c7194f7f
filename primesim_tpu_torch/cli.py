"""`python -m primesim_tpu_torch`: the port's command line.

    python -m primesim_tpu_torch run configs/rung1_64core_fft.json \\
        --synth fft_like:n_phases=2 --fold --report report.txt
    python -m primesim_tpu_torch run cfg.json --trace a.ptpu --trace b.ptpu
    python -m primesim_tpu_torch synth lock_contention:n_critical=32 \\
        --cores 64 --out lc.ptpu
    python -m primesim_tpu_torch info configs/example_prime.xml

`run` simulates a trace (PTPU files or a named synthetic generator) on a
JSON or reference-schema XML machine config, prints the one-line JSON
summary of `primetpu run` and optionally writes the same text report.
Several `--trace` flags multiplex their programs into one machine (the
reference's multiprogrammed mode). `--debug-invariants` checks the
machine invariants after every chunk; `--obs basic|full` records a
per-chunk metric series (`--metrics-out`) and a Chrome trace of the chunks
(`--trace-out`); `--xprof DIR` writes a torch.profiler trace of the run.
`--fault-schedule FILE [--fault-seed N]` arms fault injection (DESIGN.md
§12). A run is on the card unless `--device cpu` is given. `synth` writes
a generator's trace as a PTPU file, `info` prints a config as JSON: both
as `primetpu` does. A malformed schedule, trace or config exits 2 with
one `{"error": {type, location, detail}}` JSON line on stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
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
    if args:
        for pair in args.split(","):
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


def _load_trace(ns, n_cores: int, line_bits: int = 6) -> Trace:
    """--trace FILE (repeated: the programs multiplexed into one machine,
    then folded) or --synth SPEC."""
    if ns.trace:
        from .trace.format import multiplex

        trs = [Trace.load(p) for p in ns.trace]
        # several --trace flags = the reference's MULTIPROGRAMMED mode:
        # each program gets a disjoint address window and sync objects,
        # all sharing this machine's uncore
        tr = trs[0] if len(trs) == 1 else multiplex(trs, line_bits=line_bits)
        return fold_ins(tr) if ns.fold else tr
    if ns.synth:
        return _parse_synth(ns.synth, n_cores, ns.fold)
    raise SystemExit("run: need --trace FILE or --synth SPEC")


def _load_config(path: str) -> MachineConfig:
    if path.endswith(".xml"):
        from .config.xml_compat import load_xml

        return load_xml(path)
    with open(path) as f:
        return MachineConfig.from_json(f.read())


def _apply_step_impl(ns, cfg: MachineConfig) -> MachineConfig:
    """--step-impl sets the config's field (the summary reports it); the
    port runs its own kernels either way."""
    if ns.step_impl and ns.step_impl != cfg.step_impl:
        cfg = dataclasses.replace(cfg, step_impl=ns.step_impl)
    return cfg


def _build_recorder(ns):
    """--obs flags -> obs.Recorder, or None at level off (which keeps every
    telemetry branch of the engine dead)."""
    if ns.trace_out and ns.obs != "full":
        raise SystemExit(
            "--trace-out requires --obs full (the flight recorder only "
            "runs at full)"
        )
    if ns.metrics_out and ns.obs == "off":
        raise SystemExit("--metrics-out requires --obs basic|full")
    if ns.obs == "off":
        return None
    from .obs import Recorder

    return Recorder(ns.obs, capacity=ns.obs_capacity,
                    trace_path=ns.trace_out, metrics_path=ns.metrics_out)


def _finalize_obs(rec) -> None:
    """Write the recorder's output files."""
    if rec is None:
        return
    for kind, (path, n) in rec.finalize().items():
        print(f"obs: {kind} written to {path} ({n} records)", file=sys.stderr)


def _emit_summary(ns, cfg, counters, cycles, wall, extra, timeline=None) -> None:
    """`primetpu run`'s one-line JSON summary (the port's engine name, its
    device and step count added) and optional text report."""
    from .stats.report import write_report

    tot_ins = int(counters["instructions"].sum())
    detail = {
        "engine": "torch",
        "step_impl": cfg.step_impl,
        "n_cores": cfg.n_cores,
        "instructions": tot_ins,
        "max_core_cycles": int(max(cycles)),
        "wall_s": round(wall, 3),
        "noc_msgs": int(counters["noc_msgs"].sum()),
        **extra,
    }
    if timeline:
        detail["timeline"] = {
            "chunks": timeline["chunks"],
            "peak_chunk_mips": round(timeline["peak_chunk_mips"], 3),
            "mean_chunk_mips": round(timeline["mean_chunk_mips"], 3),
            "slowest_chunk_seq": timeline["slowest_chunk_seq"],
        }
    print(json.dumps({
        "metric": "simulated_MIPS",
        "value": round(tot_ins / wall / 1e6, 3),
        "unit": "MIPS",
        "detail": detail,
    }))
    if ns.report:
        write_report(ns.report, cfg, counters, cycles, wall_s=wall,
                     per_core_limit=ns.per_core_limit, timeline=timeline)
        print(f"report written to {ns.report}", file=sys.stderr)


def cmd_run(ns) -> int:
    from .kernels import build
    from .sim.engine import Engine, resolve_device

    cfg = _apply_faults(ns, _apply_step_impl(ns, _load_config(ns.config)))
    tr = _load_trace(ns, cfg.n_cores, line_bits=cfg.line_bits)
    if tr.n_cores != cfg.n_cores:
        raise SystemExit(
            f"trace has {tr.n_cores} cores but config has {cfg.n_cores}"
        )
    rec = _build_recorder(ns)
    if rec is not None and ns.xprof:
        raise SystemExit(
            "--obs does not compose with --xprof (pick the flight "
            "recorder OR the XLA profiler for a given run)"
        )
    device = resolve_device(ns.device)
    if device.type == "cuda":
        for k in build.KERNELS:  # build and load before the clock starts
            build.library(k)
    eng = Engine(cfg, tr, chunk_steps=ns.chunk_steps, device=device)
    if rec is not None:
        rec.attach(eng)
    max_steps = ns.max_steps or 10_000_000
    prof = contextlib.nullcontext()
    if ns.xprof:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    t0 = time.perf_counter()
    with prof:
        eng.run(max_steps=max_steps, debug_invariants=ns.debug_invariants)
    wall = time.perf_counter() - t0
    if ns.xprof:
        os.makedirs(ns.xprof, exist_ok=True)
        prof.export_chrome_trace(os.path.join(ns.xprof, "trace.json"))
        print(f"profiler trace written to {ns.xprof}", file=sys.stderr)
    _emit_summary(
        ns, cfg, eng.counters, eng.cycles, wall,
        {"device": str(device), "steps": eng.steps_run},
        timeline=rec.timeline_summary() if rec is not None else None,
    )
    _finalize_obs(rec)
    return 0


def cmd_synth(ns) -> int:
    tr = _parse_synth(ns.spec, ns.cores, ns.fold)
    tr.save(ns.out)
    print(
        f"wrote {ns.out}: {tr.n_cores} cores x {tr.max_len} events "
        f"({tr.total_instructions():,} instructions)",
        file=sys.stderr,
    )
    return 0


def cmd_info(ns) -> int:
    print(_load_config(ns.config).to_json())
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m primesim_tpu_torch",
        description="manycore simulator, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="simulate a trace on a machine config")
    r.add_argument("config", help="machine config (.json or reference-schema .xml)")
    src = r.add_mutually_exclusive_group()
    src.add_argument(
        "--trace", action="append",
        help="PTPU trace file (repeat for a MULTIPROGRAMMED run: each "
             "program's cores/addresses/sync multiplex into one machine)",
    )
    src.add_argument("--synth", help="synthetic workload spec name[:k=v,...]")
    r.add_argument(
        "--fold", action="store_true", help="fold INS batches into pre fields"
    )
    r.add_argument(
        "--step-impl", choices=("xla", "pallas"), default=None,
        help="the JAX package's step implementation: recorded in the "
             "config and the summary; the port runs its own kernels",
    )
    r.add_argument("--chunk-steps", type=int, default=256)
    r.add_argument("--max-steps", type=int, default=None)
    r.add_argument("--report", help="write the text report to this path")
    r.add_argument("--per-core-limit", type=int, default=64)
    r.add_argument(
        "--debug-invariants", action="store_true",
        help="check DESIGN.md machine invariants after every chunk "
             "(slower, chunked dispatch)",
    )
    r.add_argument(
        "--xprof", metavar="DIR",
        help="write a torch.profiler trace of the run to DIR/trace.json "
             "(Chrome trace format)",
    )
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
        "--obs", choices=("off", "basic", "full"), default="off",
        help="telemetry level: off (default), basic (per-chunk metric "
             "time-series, chunked dispatch), full (basic + flight-recorder "
             "timeline)",
    )
    r.add_argument(
        "--metrics-out", metavar="FILE",
        help="dump the per-chunk metric series as JSONL at exit "
             "(needs --obs basic|full)",
    )
    r.add_argument(
        "--trace-out", metavar="FILE",
        help="write the Chrome trace-event timeline at exit — load it "
             "in Perfetto / chrome://tracing (needs --obs full)",
    )
    r.add_argument(
        "--obs-capacity", type=int, default=4096, metavar="N",
        help="metric ring-buffer size in chunks; older samples drop "
             "first (default 4096)",
    )
    r.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="default: cuda (an error when there is no card)",
    )
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("synth", help="generate a synthetic PTPU trace file")
    s.add_argument("spec", help="generator spec name[:k=v,...]")
    s.add_argument("--cores", type=int, required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--fold", action="store_true")
    s.set_defaults(fn=cmd_synth)

    i = sub.add_parser("info", help="parse + print a machine config")
    i.add_argument("config")
    i.set_defaults(fn=cmd_info)
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
