"""`python -m primesim_tpu_torch`: the port's command line.

    python -m primesim_tpu_torch run configs/rung1_64core_fft.json \\
        --synth fft_like:n_phases=2 --fold --report report.txt
    python -m primesim_tpu_torch run cfg.json --trace a.ptpu --trace b.ptpu
    python -m primesim_tpu_torch synth lock_contention:n_critical=32 \\
        --cores 64 --out lc.ptpu
    python -m primesim_tpu_torch info configs/example_prime.xml
    python -m primesim_tpu_torch sweep configs/rung1_64core_fft.json \
        --synth fft_like:n_phases=2 --fold --vary llc_lat=20 --vary link_lat=2

`run` simulates a trace (PTPU files or a named synthetic generator) on a
JSON or reference-schema XML machine config, prints the one-line JSON
summary of `primetpu run` and optionally writes the same text report.
Several `--trace` flags multiplex their programs into one machine (the
reference's multiprogrammed mode). `--debug-invariants` checks the
machine invariants after every chunk; `--obs basic|full` records a
per-chunk metric series (`--metrics-out`) and a Chrome trace of the chunks
(`--trace-out`); `--xprof DIR` writes a torch.profiler trace of the run.
`--fault-schedule FILE [--fault-seed N]` arms fault injection (DESIGN.md
§12). Any of `--checkpoint-dir`, `--checkpoint-every`, `--checkpoint-wall`,
`--resume` and `--guard` puts a run or sweep under `RunSupervisor`
(rotating snapshots, preemption at a chunk boundary with exit 75, retry
with an on-device rollback, the invariant guard) and adds a RESILIENCE
section to the report. `sweep` fans one config into a fleet
(`sim/fleet.py`): one element per `--vary K=V[,K=V...]` timing-override
set and/or per trace, all run as ONE batch on the card, and prints
`primetpu sweep`'s lines: one `simulated_MIPS` line per element
(quarantined elements and deduplicated twins included) and a
`fleet_aggregate_MIPS` line; `--fork-prefix auto|N` runs each
prefix-sharing class's shared prefix once and forks it into the fleet
(`sim/prefix.py`, a `prefix_fork` line), and `--warm-cache on` keeps
those prefixes on disk ($PRIMETPU_CACHE_DIR, bounded by `--cache-budget`)
for the next campaign. A run or sweep is on the card unless `--device
cpu` is given. `synth` writes
a generator's trace as a PTPU file, `info` prints a config as JSON: both
as `primetpu` does. A malformed schedule, trace or config exits 2 with
one `{"error": {type, location, detail}}` JSON line on stderr, as does
a malformed `--vary` spec.
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


def _emit_summary(ns, cfg, counters, cycles, wall, extra, timeline=None,
                  resilience=None) -> None:
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
                     per_core_limit=ns.per_core_limit, timeline=timeline,
                     resilience=resilience)
        print(f"report written to {ns.report}", file=sys.stderr)


def _supervised(ns) -> bool:
    """Any resilience flag engages the supervised (chunk-committed) path."""
    return bool(
        ns.resume or ns.checkpoint_dir or ns.checkpoint_every
        or ns.checkpoint_wall or ns.guard != "off"
    )


def _check_supervision_flags(ns) -> None:
    if (
        ns.resume or ns.checkpoint_every or ns.checkpoint_wall
    ) and not ns.checkpoint_dir:
        raise SystemExit(
            "--resume/--checkpoint-every/--checkpoint-wall require "
            "--checkpoint-dir DIR (where snapshots live)"
        )


def _configure_disk(ns) -> None:
    """--cache-budget: the one byte budget of the warm-state cache and
    the disk-pressure ladder."""
    from .util import diskpressure

    if ns.cache_budget is not None:
        diskpressure.configure(budget_bytes=ns.cache_budget)


def _build_supervisor(ns, eng, obs=None):
    from .sim.supervisor import RunSupervisor

    return RunSupervisor(
        eng,
        snapshot_dir=ns.checkpoint_dir,
        keep_snapshots=ns.keep_snapshots,
        checkpoint_every_chunks=ns.checkpoint_every,
        checkpoint_every_s=ns.checkpoint_wall,
        guard=ns.guard,
        max_retries=ns.max_retries,
        obs=obs,
    )


def _emit_preempted(e, sup) -> int:
    """Preemption is a clean outcome, not a crash: report where the run
    stopped and exit 75 (EX_TEMPFAIL: rerun with --resume)."""
    print(f"preempted: {e}", file=sys.stderr)
    print(json.dumps({
        "metric": "preempted",
        "value": None,
        "unit": None,
        "detail": {"checkpoint": e.checkpoint, "signal": e.signum, **sup.summary()},
    }))
    return 75


def _run_supervised(ns, cfg, eng, device, rec=None) -> int:
    """Supervised `run` path: chunk-committed execution under a
    RunSupervisor (auto-checkpoint, preemption, retry, guard)."""
    from .sim.supervisor import Preempted

    if rec is not None:
        rec.attach(eng)
    sup = _build_supervisor(ns, eng, obs=rec)
    if ns.resume:
        sup.resume()
    t0 = time.perf_counter()
    try:
        sup.run(max_steps=ns.max_steps)  # None -> the supervisor's budget
    except Preempted as e:
        _finalize_obs(rec)  # the flight recorder survives preemption
        return _emit_preempted(e, sup)
    wall = time.perf_counter() - t0
    _emit_summary(
        ns, cfg, eng.counters, eng.cycles, wall,
        {"device": str(device), "steps": eng.steps_run, **sup.summary()},
        timeline=rec.timeline_summary() if rec is not None else None,
        resilience=sup.log_lines(),
    )
    _finalize_obs(rec)
    return 0


def cmd_run(ns) -> int:
    from .kernels import build
    from .sim.engine import Engine, resolve_device

    cfg = _apply_faults(ns, _apply_step_impl(ns, _load_config(ns.config)))
    tr = _load_trace(ns, cfg.n_cores, line_bits=cfg.line_bits)
    if tr.n_cores != cfg.n_cores:
        raise SystemExit(
            f"trace has {tr.n_cores} cores but config has {cfg.n_cores}"
        )
    _check_supervision_flags(ns)
    supervised = _supervised(ns)
    if supervised and (ns.xprof or ns.debug_invariants):
        raise SystemExit(
            "--xprof/--debug-invariants do not compose with the supervised "
            "path (--guard runs the same invariants post-chunk)"
        )
    _configure_disk(ns)
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
    if supervised:
        return _run_supervised(ns, cfg, eng, device, rec=rec)
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


class VarySpecError(ValueError):
    """A malformed --vary spec (bad shape, unknown key, non-integer
    value): `main` exits 2 with the structured {"error": ...} JSON, as
    `primetpu sweep` does."""

    def __init__(self, msg: str, pair: str | None = None):
        super().__init__(msg)
        self.pair = pair

    def location(self) -> dict:
        return {"pair": self.pair} if self.pair is not None else {}


def _parse_vary(spec: str) -> dict:
    """Parse one --vary spec 'k=v[,k=v...]' into a timing-override dict
    (keys validated against sim.fleet.KNOB_KEYS here AND by the
    FleetEngine: here so the error names the offending pair)."""
    from .sim.fleet import KNOB_KEYS

    ov = {}
    for pair in spec.split(","):
        k, eq, v = pair.partition("=")
        if not eq or not k:
            raise VarySpecError(
                f"bad --vary arg {pair!r} (want key=value; valid keys: "
                f"{', '.join(KNOB_KEYS)})",
                pair=pair,
            )
        if k not in KNOB_KEYS:
            raise VarySpecError(
                f"bad --vary arg {pair!r}: unknown key {k!r} (valid keys: "
                f"{', '.join(KNOB_KEYS)})",
                pair=pair,
            )
        try:
            ov[k] = int(v)
        except ValueError:
            raise VarySpecError(
                f"bad --vary arg {pair!r}: value must be an integer "
                f"(valid keys: {', '.join(KNOB_KEYS)})",
                pair=pair,
            ) from None
    return ov


def _error_obj(exc: BaseException) -> dict:
    """{"error": {type, location, detail}} of an exception, its own
    `location()` included when it has one."""
    locate = getattr(exc, "location", None)
    return {"error": {
        "type": type(exc).__name__,
        "location": dict(locate()) if callable(locate) else {},
        "detail": str(exc),
    }}


def _element_line(cfg, i, ov, counters, cycles, j, wall, **extra) -> dict:
    """One element's `simulated_MIPS` line, from fleet position j."""
    ins = int(counters["instructions"][j].sum())
    return {
        "metric": "simulated_MIPS",
        "value": round(ins / wall / 1e6, 3),
        "unit": "MIPS",
        "detail": {
            "engine": "fleet",
            "fleet_index": i,
            "n_cores": cfg.n_cores,
            "instructions": ins,
            "max_core_cycles": int(cycles[j].max()),
            "overrides": ov,
            "wall_s": round(wall, 3),
            "noc_msgs": int(counters["noc_msgs"][j].sum()),
            **extra,
        },
    }


def cmd_sweep(ns) -> int:
    """Fan a config + timing overrides and/or traces into ONE fleet run
    (sim.fleet.FleetEngine): the batch retires one event per core per
    element per step, through one set of kernel launches a step. Emits
    one JSON summary line per element (ordered by caller index) plus a
    fleet_aggregate_MIPS line.

    Fault isolation is the default: an element whose trace file is
    unreadable or malformed, or whose overrides are invalid, is
    QUARANTINED (reported in its own JSON line, with the TraceError's
    core/offset when available) while the rest of the batch runs;
    `--strict` makes any bad element fatal instead."""
    import numpy as np

    from .kernels import build
    from .sim.engine import resolve_device
    from .sim.fleet import FleetEngine
    from .sim.prefix import dedup_plan, execute_prefix_plan, plan_prefix
    from .sim.supervisor import Preempted, build_fleet_isolated
    from .stats.report import write_report

    if ns.fork_prefix not in ("auto", "off"):
        try:
            int(ns.fork_prefix)
        except ValueError:
            raise SystemExit(
                f"sweep: --fork-prefix must be auto, off, or an integer "
                f"step cap (got {ns.fork_prefix!r})"
            ) from None
    cfg = _apply_faults(ns, _apply_step_impl(ns, _load_config(ns.config)))
    _check_supervision_flags(ns)
    _configure_disk(ns)

    # per-element SOURCES: callables for file loads (so an unreadable file
    # quarantines one element, not the sweep), eager traces for synth specs
    def _loader(path):
        def load():
            t = Trace.load(path)
            return fold_ins(t) if ns.fold else t

        return load

    sources: list = [_loader(p) for p in (ns.trace or [])]
    for spec in ns.synth or []:
        sources.append(_parse_synth(spec, cfg.n_cores, ns.fold))
    if not sources:
        raise SystemExit("sweep: need --trace FILE and/or --synth SPEC")
    ovs = [_parse_vary(s) for s in (ns.vary or [])]
    A, V = len(sources), len(ovs)
    # fan rule: equal lengths pair up; a single trace (or single --vary)
    # replicates across the other axis; anything else is ambiguous
    if V == 0:
        ovs = [{}] * A
    elif A == 1 and V > 1:
        sources = sources * V
    elif V == 1 and A > 1:
        ovs = ovs * A
    elif A != V:
        raise SystemExit(
            f"sweep: {A} traces vs {V} --vary sets — lengths must match, "
            "or one side must be a single entry to replicate"
        )
    rec = _build_recorder(ns)
    device = resolve_device(ns.device)
    if device.type == "cuda":
        for k in build.KERNELS:  # build and load before the clock starts
            build.library(k)
    if ns.strict:
        traces = [s() if callable(s) else s for s in sources]
        fleet = FleetEngine(cfg, traces, ovs, chunk_steps=ns.chunk_steps, device=device)
        quarantined: list = []
    else:
        fleet, quarantined = build_fleet_isolated(
            cfg, sources, ovs, chunk_steps=ns.chunk_steps, device=device
        )
    for i, err in quarantined:
        detail = {
            "engine": "fleet",
            "fleet_index": i,
            "status": "quarantined",
            "overrides": ovs[i],
            **_error_obj(err),
        }
        if isinstance(err, TraceError):
            detail.update(err.location())
        print(json.dumps({"metric": "quarantined", "value": None, "unit": None,
                          "detail": detail}))
    if fleet is None:
        print("sweep: every element was quarantined", file=sys.stderr)
        return 1

    # identical-element dedup: two elements with equal (trace, effective
    # config) would simulate the same run twice; keep the first and fan
    # its lines out to the twins afterwards
    dup_of_caller: dict[int, int] = {}
    if fleet.n_elements > 1:
        keep, dup_of = dedup_plan(fleet.elem_cfgs, fleet.traces)
        if dup_of:
            ids = fleet.element_ids
            dup_of_caller = {ids[j]: ids[k] for j, k in dup_of.items()}
            print(
                "sweep: WARNING: deduplicated "
                f"{len(dup_of)} identical element(s) — "
                + ", ".join(f"{ids[j]} duplicates {ids[k]}" for j, k in sorted(dup_of.items()))
                + " (simulated once, reports fanned out)",
                file=sys.stderr,
            )
            kept_ids = [ids[j] for j in keep]
            fleet = FleetEngine(
                cfg, [fleet.traces[j] for j in keep],
                [fleet.element_overrides[j] for j in keep],
                chunk_steps=ns.chunk_steps, device=device,
            )
            fleet.element_ids = kept_ids
    fleet.block_until_ready()
    if rec is not None:
        rec.attach(fleet)

    def _fork_now() -> dict:
        # run (or warm-load) each prefix-sharing class's shared prefix and
        # fork it into the slots; the metric line records what was skipped
        groups = plan_prefix(
            fleet.elem_cfgs, fleet.traces, mode=ns.fork_prefix,
            chunk_steps=ns.chunk_steps, cap=ns.max_steps or 10_000_000,
        )
        st = execute_prefix_plan(fleet, groups, warm_cache=ns.warm_cache == "on", obs=rec)
        st["mode"] = ns.fork_prefix
        st["warm_cache"] = ns.warm_cache
        if dup_of_caller:
            st["deduped"] = sorted(dup_of_caller)
        print(json.dumps({"metric": "prefix_fork", "value": st["forked_elements"],
                          "unit": "elements", "detail": st}))
        return st

    stalled: list[int] = []
    if _supervised(ns):
        sup = _build_supervisor(ns, fleet, obs=rec)
        resumed = sup.resume() if ns.resume else None
        if resumed is None and ns.fork_prefix != "off":
            # a restored snapshot is already past the prefix (and carries
            # its fork provenance); fork only on a fresh start
            _fork_now()
        t0 = time.perf_counter()
        try:
            sup.run(max_steps=ns.max_steps or 10_000_000)
        except Preempted as e:
            _finalize_obs(rec)
            return _emit_preempted(e, sup)
        wall = time.perf_counter() - t0
        stalled = list(sup.stalled_elements)
        for line in sup.log_lines():
            print(f"supervisor: {line}", file=sys.stderr)
    else:
        if ns.fork_prefix != "off":
            _fork_now()
        t0 = time.perf_counter()
        try:
            if rec is not None:
                # chunked dispatch so every chunk lands in the metric ring
                fleet.run_steps(ns.max_steps or 10_000_000)
                if not fleet.done():
                    bad = np.flatnonzero(~fleet.done_mask()).tolist()
                    raise RuntimeError(
                        f"fleet: max_steps exceeded on element(s) {bad} (deadlock?)"
                    )
            else:
                fleet.run(max_steps=ns.max_steps or 10_000_000)
        except RuntimeError as e:
            # stalled elements are isolated, as quarantine is: reported,
            # and the finished elements' results kept
            stalled = [fleet.element_ids[j] for j in np.flatnonzero(~fleet.done_mask())]
            print(f"sweep: {e} — isolating", file=sys.stderr)
        wall = time.perf_counter() - t0

    counters = fleet.counters
    cycles = fleet.cycles
    if ns.report_dir:
        os.makedirs(ns.report_dir, exist_ok=True)

    def report(i, j, title):
        if ns.report_dir:
            path = os.path.join(ns.report_dir, f"element_{i}.txt")
            write_report(
                path, fleet.elem_cfgs[j], {k: v[j] for k, v in counters.items()},
                cycles[j], wall_s=wall, per_core_limit=ns.per_core_limit, title=title,
            )
            print(f"report written to {path}", file=sys.stderr)

    total_ins = 0
    for j, i in enumerate(fleet.element_ids):  # caller-side index
        line = _element_line(cfg, i, ovs[i], counters, cycles, j, wall,
                             **({"status": "stalled"} if i in stalled else {}))
        total_ins += line["detail"]["instructions"]
        print(json.dumps(line))
        report(i, j, f"primesim_tpu fleet element {i}")
    # the deduplicated twins: identical inputs give identical results,
    # copied from the element that simulated; they add nothing to the
    # aggregate (no instructions were retired on their behalf)
    for i, twin in sorted(dup_of_caller.items()):
        jt = fleet.element_ids.index(twin)
        extra = {"dedup_of": twin, **({"status": "stalled"} if twin in stalled else {})}
        print(json.dumps(_element_line(cfg, i, ovs[i], counters, cycles, jt, wall, **extra)))
        report(i, jt, f"primesim_tpu fleet element {i} (dedup of {twin})")
    agg = {
        "engine": "fleet",
        "n_elements": fleet.n_elements,
        "n_cores": cfg.n_cores,
        "instructions": total_ins,
        "wall_s": round(wall, 3),
    }
    if dup_of_caller:
        agg["deduplicated"] = sorted(dup_of_caller)
    if quarantined:
        agg["quarantined"] = [i for i, _ in quarantined]
    if stalled:
        agg["stalled"] = stalled
    print(json.dumps({"metric": "fleet_aggregate_MIPS",
                      "value": round(total_ins / wall / 1e6, 3),
                      "unit": "MIPS", "detail": agg}))
    if rec is not None:
        tl = rec.timeline_summary()
        if tl:
            print(json.dumps({"metric": "obs_timeline", "value": tl["chunks"],
                              "unit": "chunks", "detail": tl}))
        _finalize_obs(rec)
    if quarantined or stalled:
        # partial success is its own exit code: the healthy elements'
        # results are real
        print(
            f"sweep: partial — {len(quarantined)} quarantined, "
            f"{len(stalled)} stalled of "
            f"{fleet.n_elements + len(quarantined)} elements",
            file=sys.stderr,
        )
        return 3
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


def _add_shared_flags(sp) -> None:
    """run's and sweep's fault, telemetry and device flags."""
    sp.add_argument(
        "--fault-schedule", metavar="FILE",
        help="JSON fault schedule (events, flip and DUE rates, policies); "
             "arms the deterministic fault model (DESIGN.md §12)",
    )
    sp.add_argument(
        "--fault-seed", type=int, default=None, metavar="N",
        help="seed of the counter-based fault PRNG (default 0)",
    )
    sp.add_argument(
        "--obs", choices=("off", "basic", "full"), default="off",
        help="telemetry level: off (default), basic (per-chunk metric "
             "time-series, chunked dispatch), full (basic + flight-recorder "
             "timeline)",
    )
    sp.add_argument(
        "--metrics-out", metavar="FILE",
        help="dump the per-chunk metric series as JSONL at exit "
             "(needs --obs basic|full)",
    )
    sp.add_argument(
        "--trace-out", metavar="FILE",
        help="write the Chrome trace-event timeline at exit — load it "
             "in Perfetto / chrome://tracing (needs --obs full)",
    )
    sp.add_argument(
        "--obs-capacity", type=int, default=4096, metavar="N",
        help="metric ring-buffer size in chunks; older samples drop "
             "first (default 4096)",
    )
    sp.add_argument(
        "--cache-budget", type=int, default=None, metavar="BYTES",
        help="byte budget of the governed artifact pool (the warm-state "
             "cache; DESIGN.md §26): LRU pruning and the disk-pressure "
             "evict ladder both honor it; takes precedence over "
             "$PRIMETPU_CACHE_MAX_BYTES (default: env var, then 2 GiB)",
    )
    sp.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="default: cuda (an error when there is no card)",
    )
    _add_resilience_flags(sp)


def _add_resilience_flags(sp) -> None:
    """run's and sweep's resilience surface (DESIGN.md §10): any of these
    flags puts the command on the supervised chunk-committed path
    (sim.supervisor.RunSupervisor); results stay bit-exact."""
    sp.add_argument(
        "--checkpoint-dir", metavar="DIR",
        help="rotating-snapshot directory (ckpt-<seq>.npz, atomic + "
             "CRC-verified); enables checkpointing and --resume",
    )
    sp.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="K",
        help="checkpoint every K committed chunks (needs --checkpoint-dir)",
    )
    sp.add_argument(
        "--checkpoint-wall", type=float, default=0.0, metavar="SEC",
        help="checkpoint when SEC wall-seconds passed since the last one "
             "(needs --checkpoint-dir; combines with --checkpoint-every)",
    )
    sp.add_argument(
        "--keep-snapshots", type=int, default=3, metavar="N",
        help="rotating snapshots retained in --checkpoint-dir (default 3)",
    )
    sp.add_argument(
        "--resume", action="store_true",
        help="restore the newest VALID snapshot from --checkpoint-dir "
             "(corrupt ones are skipped; config+trace fingerprints are "
             "verified) and continue — bit-exact with an uninterrupted run",
    )
    sp.add_argument(
        "--guard", choices=("off", "warn", "fail"), default="off",
        help="post-chunk invariant guard (MESI/directory consistency, "
             "clock window, monotone counters): warn logs violations, "
             "fail stops BEFORE checkpointing the bad state",
    )
    sp.add_argument(
        "--max-retries", type=int, default=4, metavar="N",
        help="retries per chunk on transient device failures (decorrelated "
             "jitter backoff; OOM halves chunk_steps; each failed attempt "
             "is rolled back on the device). Then the run gives up with "
             "the original error",
    )


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
    _add_shared_flags(r)
    r.set_defaults(fn=cmd_run)

    w = sub.add_parser(
        "sweep",
        help="fan timing overrides and/or traces into ONE batched fleet "
             "run (one set of kernel launches a step; one line per element)",
    )
    w.add_argument("config", help="machine config (.json or reference-schema .xml)")
    w.add_argument(
        "--trace", action="append",
        help="PTPU trace file (repeat for per-element traces)",
    )
    w.add_argument(
        "--synth", action="append",
        help="synthetic workload spec name[:k=v,...] (repeatable)",
    )
    w.add_argument(
        "--vary", action="append", metavar="K=V[,K=V...]",
        help="one fleet element's timing overrides (repeatable; keys: "
             "quantum, cpi, l1_lat, llc_lat, link_lat, router_lat, "
             "dram_lat, dram_service, contention_lat, prefetch_degree, "
             "prefetch_lat, fault_seed)",
    )
    w.add_argument(
        "--fold", action="store_true", help="fold INS batches into pre fields"
    )
    w.add_argument(
        "--step-impl", choices=("xla", "pallas"), default=None,
        help="the JAX package's step implementation: recorded in every "
             "element's config; the port runs its own kernels",
    )
    w.add_argument("--chunk-steps", type=int, default=256)
    w.add_argument("--max-steps", type=int, default=None)
    w.add_argument(
        "--fork-prefix", default="off", metavar="auto|off|N",
        help="run each prefix-sharing class's shared prefix ONCE as a "
             "solo engine and fork it into the fleet slots (bit-exact; "
             "'auto' forks at the divergence point, an integer caps the "
             "prefix at N steps; default off)",
    )
    w.add_argument(
        "--warm-cache", choices=("on", "off"), default="off",
        help="consult/populate the on-disk warm-state cache "
             "($PRIMETPU_CACHE_DIR) for forked prefixes — a repeated "
             "campaign skips the prefix simulation entirely",
    )
    w.add_argument(
        "--report-dir", help="write per-element text reports to this directory"
    )
    w.add_argument("--per-core-limit", type=int, default=64)
    w.add_argument(
        "--strict", action="store_true",
        help="disable fleet fault isolation: any malformed element "
             "(unreadable trace, bad overrides) aborts the whole sweep "
             "instead of being quarantined into its own JSON line",
    )
    _add_shared_flags(w)
    w.set_defaults(fn=cmd_sweep)

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
    except (TraceError, ConfigError, FaultConfigError, VarySpecError) as e:
        # typed errors exit 2 with ONE structured JSON line on stderr, as
        # `primetpu` prints them
        print(json.dumps(_error_obj(e)), file=sys.stderr)
        return 2
