"""`python -m primesim_tpu_torch`: the port's command line.

    python -m primesim_tpu_torch run configs/rung1_64core_fft.json \\
        --synth fft_like:n_phases=2 --fold --report report.txt
    python -m primesim_tpu_torch run cfg.json --trace a.ptpu --trace b.ptpu
    python -m primesim_tpu_torch synth lock_contention:n_critical=32 \\
        --cores 64 --out lc.ptpu
    python -m primesim_tpu_torch info configs/example_prime.xml
    python -m primesim_tpu_torch sweep configs/rung1_64core_fft.json \
        --synth fft_like:n_phases=2 --fold --vary llc_lat=20 --vary link_lat=2
    python -m primesim_tpu_torch run cfg.json --trace big.ptpu --mmap \
        --stream-window 4096
    python -m primesim_tpu_torch capture cfg.json -- ./pthread_app 4
    python -m primesim_tpu_torch run cfg.json --synth fft_like --fold \
        --attest chain
    python -m primesim_tpu_torch serve cfg.json --state-dir D --attest chain
    python -m primesim_tpu_torch submit --socket D/serve.sock \
        --synth fft_like:n_phases=2 --fold --vary llc_lat=20 --wait
    python -m primesim_tpu_torch serve-status --socket D/serve.sock
    python -m primesim_tpu_torch sweep cfg.json --synth fft_like --fold \
        --vary llc_lat=20 --vary link_lat=2 --workers 2 --pool-dir P
    python -m primesim_tpu_torch run cfg.json --trace big.ptpu \
        --stream-window 128 --ingest-workers 2 --seg-events 256
    python -m primesim_tpu_torch serve cfg.json --state-dir D --pool-dir P \
        --workers 2 --attest chain --audit-rate 1.0
    python -m primesim_tpu_torch replica --dir R0 --tcp 127.0.0.1:7101
    python -m primesim_tpu_torch serve cfg.json --state-dir D \
        --replicas 127.0.0.1:7101,127.0.0.1:7102 [--standby-of PRIMARY]
    python -m primesim_tpu_torch fsck D [--compare D R0]
    python -m primesim_tpu_torch audit P
    python -m primesim_tpu_torch chaos --trials 20 --seed 0 [--plan F]
    python -m primesim_tpu_torch calibrate configs/rung1_64core_fft.json \
        --table configs/calib_ipu_microbench.json

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
section to the report. `--stream-window N` streams the trace through
N-event windows (`ingest/stream.py`: one window on the card at a time,
bit-exact with the preloaded run), and `--mmap` memory-maps a single
trace file for it. `capture` runs a pthread binary under the capture
shim and simulates it online while it runs (`ingest/ring.py`), or with
`--out` writes the captured trace. `sweep` fans one config into a fleet
(`sim/fleet.py`): one element per `--vary K=V[,K=V...]` timing-override
set and/or per trace, all run as ONE batch on the card, and prints
`primetpu sweep`'s lines: one `simulated_MIPS` line per element
(quarantined elements and deduplicated twins included) and a
`fleet_aggregate_MIPS` line; `--fork-prefix auto|N` runs each
prefix-sharing class's shared prefix once and forks it into the fleet
(`sim/prefix.py`, a `prefix_fork` line), and `--warm-cache on` keeps
those prefixes on disk ($PRIMETPU_CACHE_DIR, bounded by `--cache-budget`)
for the next campaign. `run --attest chain` fingerprints every committed
chunk (every window of a streamed run) into a chain whose head joins the
summary as `attest` (attest/chain.py: the JAX package's heads). `serve`
is the continuous-batching daemon (serve/server.py: jobs over a unix
socket or `--tcp HOST:PORT`, journaled, checkpointed per job, drained on
SIGTERM with exit 75 when work remains, SIGHUP reloads the config);
`submit` sends it one job (exit 4 on backpressure), `serve-status` asks
for its health, jobs, metrics, a live line (`--watch`) or a drain.
`sweep --workers N` runs the sweep as an elastic pooled campaign
(pool/: a lease coordinator in this process and N `worker` processes,
crash-resumed from per-unit checkpoints under `--pool-dir`; `--attest
chain` and `--audit-rate` compare and audit their chain heads), `run
--stream-window W --ingest-workers K` fills the windows from trace
segments K `worker` processes write ahead (ingest/pipeline.py), and
`serve --pool-dir` dispatches jobs to an autoscaled pool of `worker`
processes behind a spawned or adopted `coordinator` (serve/dispatch.py).
Every one of those children is a `python -m primesim_tpu_torch` process,
given `--device cpu` when its parent runs on the CPU. `serve --replicas`
replicates the daemon's journal to `replica` followers and ACKs a submit
once a quorum of them holds it (serve/replicate.py); `serve --standby-of`
waits for a primary to die and promotes itself off the replicas with a
fencing epoch. `fsck` verifies durable state without simulating (and
`--compare` two journal chains frame for frame), `audit` replays a pool
directory's finished units and holds their chain heads to the ledger's;
replica and fsck processes touch no device. `chaos` runs seeded crash
campaigns over the serving stack and machine-checks its durability
invariants (chaos/campaign.py; exit 3 on a violation, shrunk to a repro
artifact that `--plan` replays), and `calibrate` fits the timing knobs to
a microbenchmark table with one fleet per candidate set (calib/), both
with `primetpu`'s output. A run, sweep, worker, daemon, campaign or fit
is on the card unless `--device cpu` is given. `--exec-cache on`
(run, sweep, worker, serve) takes the kernel libraries from the kernel
build cache under $PRIMETPU_CACHE_DIR/exec, building and persisting the
missing ones (sim/exec_cache.py), and then prints `primetpu`'s
`time_to_first_step` and `exec_cache` lines (and the port's
`exec_cache: device D, {...}` stderr line); `--overlap on` (run, sweep,
worker) enqueues each next chunk before the host's work on the committed
one (sim/engine.py: overlapped dispatch), bit-exact. Both are off by
default, and off prints exactly what the port printed before them.
`synth` writes
a generator's trace as a PTPU file, `info` prints a config as JSON: both
as `primetpu` does. A malformed schedule, trace or config exits 2 with
one `{"error": {type, location, detail}}` JSON line on stderr, as do a
malformed `--vary` spec, a `--resume` whose snapshots are all corrupt
(`CheckpointCorrupt`), a failed attestation check (`AttestationError`),
corruption found by `fsck` (`FsckCorrupt`) and a malformed calibration
table or fit key (`CalibError`).
A plan file named by `PRIMETPU_CHAOS_PLAN` is installed before anything
runs (chaos/sites.py).
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
    then folded; --mmap memory-maps a single file) or --synth SPEC."""
    if ns.trace:
        from .trace.format import multiplex

        mm = getattr(ns, "mmap", False)
        if len(ns.trace) > 1 and mm:
            raise SystemExit(
                "--mmap is incompatible with multiple --trace flags: "
                "multiplexing materializes the combined trace in RAM"
            )
        trs = [Trace.load(p, mmap=mm) for p in ns.trace]
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
                  resilience=None, engine="torch") -> None:
    """`primetpu run`'s one-line JSON summary (the port's engine name, its
    device and step count added) and optional text report."""
    from .stats.report import write_report

    tot_ins = int(counters["instructions"].sum())
    detail = {
        "engine": engine,
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


def _activate_exec_cache(ns):
    """--exec-cache on: the process-global kernel build cache (every
    kernel load of the process, the engines', a worker's and a serve
    bucket's, consults `exec_cache.active()`); None when off."""
    from .sim import exec_cache

    return exec_cache.configure(getattr(ns, "exec_cache", "off") == "on")


def _emit_exec_cache_line(cache, device=None) -> None:
    """`primetpu`'s `exec_cache` line (hits, misses, walls and the
    structured warnings), and on stderr the port's `exec_cache: device D,
    {...}` line: the kernels' launches and the entries' keys. Printed only
    when --exec-cache on."""
    if cache is None:
        return
    from .kernels import build

    detail = dict(cache.stats)
    detail["compile_wall_s"] = round(detail["compile_wall_s"], 3)
    detail["load_wall_s"] = round(detail["load_wall_s"], 3)
    if cache.warnings:
        detail["warnings"] = cache.warnings
    print(json.dumps({"metric": "exec_cache", "value": detail["hits"],
                      "unit": "hits", "detail": detail}))
    print(f"exec_cache: device {device}, " + json.dumps({
        "launches": dict(build.LAUNCHES),
        "keys": {k: v[:16] for k, v in cache.keys.items()},
    }), file=sys.stderr)


def _emit_ttfs_line(cache, t_start: float) -> None:
    """`primetpu`'s `time_to_first_step` line: the wall from the command's
    start to where the first step can be dispatched (the kernels built or
    loaded, the engine's state on the device; the port compiles nothing
    at its first step), split into the compiler's and the loads' walls.
    Printed only when --exec-cache on."""
    if cache is None:
        return
    print(json.dumps({
        "metric": "time_to_first_step",
        "value": round(time.perf_counter() - t_start, 3),
        "unit": "s",
        "detail": {
            "cold": cache.stats["misses"] > 0,
            "compile_wall_s": round(cache.stats["compile_wall_s"], 3),
            "load_wall_s": round(cache.stats["load_wall_s"], 3),
        },
    }))


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


def _build_mesh(ns, cfg, device):
    """--devices N: a validated tile mesh over the first N visible devices
    of the run's platform (or None without the flag). Cores and L1s shard
    by core, the directory by bank (`parallel/sharding.py`); a bad N (not
    dividing the cores or banks, or more devices than visible) raises the
    typed DeviceMeshError, exit 2, before anything is placed."""
    if not getattr(ns, "devices", 0):
        return None
    from .parallel.sharding import tile_mesh, validate_devices, visible_devices

    platform = "gpu" if device.type == "cuda" else "cpu"
    validate_devices(cfg, ns.devices, platform)
    mesh = tile_mesh(devices=visible_devices(platform)[: ns.devices])
    print(f"mesh: {ns.devices} devices ({mesh.platform})", file=sys.stderr)
    return mesh


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
        {"device": str(device), "steps": eng.steps_run, **sup.summary(),
         **_attest_extra(eng)},
        timeline=rec.timeline_summary() if rec is not None else None,
        resilience=sup.log_lines(),
    )
    _finalize_obs(rec)
    return 0


def cmd_run(ns) -> int:
    t_start = time.perf_counter()  # time_to_first_step's epoch
    from .ingest.stream import FAULTS_REFUSED
    from .kernels import build
    from .sim.engine import Engine, resolve_device

    cache = _activate_exec_cache(ns)
    cfg = _apply_faults(ns, _apply_step_impl(ns, _load_config(ns.config)))
    if cfg.faults_enabled and ns.stream_window:
        raise SystemExit(FAULTS_REFUSED)
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
    if ns.stream_window:
        return _run_stream(ns, cfg, tr, supervised, rec, cache, t_start)
    device = resolve_device(ns.device)
    mesh = _build_mesh(ns, cfg, device)
    if device.type == "cuda":
        build.libraries(build.KERNELS)  # build or load before the clock starts
    eng = Engine(cfg, tr, chunk_steps=ns.chunk_steps, device=device, mesh=mesh)
    eng.overlap = ns.overlap == "on"
    if ns.attest == "chain":
        # the chain covers every committed chunk of the host loop (the
        # JAX package's chunked dispatch, which attestation forces there)
        from .attest import SoloAttest

        eng.attest = SoloAttest(ns.chunk_steps)
    _emit_ttfs_line(cache, t_start)
    if supervised:
        rc = _run_supervised(ns, cfg, eng, device, rec=rec)
        _emit_exec_cache_line(cache, device)
        return rc
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
        {"device": str(device), "steps": eng.steps_run, **_attest_extra(eng)},
        timeline=rec.timeline_summary() if rec is not None else None,
    )
    _emit_exec_cache_line(cache, device)
    _finalize_obs(rec)
    return 0


def _attest_extra(eng) -> dict:
    return {} if eng.attest is None else {"attest": eng.attest.payload()}


def _run_stream(ns, cfg, tr, supervised, rec, cache=None, t_start=None) -> int:
    """`run --stream-window N`: bounded-memory windowed ingest (device
    memory O(C * N), host O(1) beyond the file with --mmap), bit-exact
    with the preloaded run; with --devices, over a tile mesh built
    before the stream, as the JAX CLI builds it."""
    from .ingest.stream import StreamEngine
    from .sim.engine import resolve_device

    if ns.xprof or ns.debug_invariants:
        raise SystemExit(
            "--xprof/--debug-invariants are not supported with "
            "--stream-window yet"
        )
    device = resolve_device(ns.device)
    mesh = _build_mesh(ns, cfg, device)
    if ns.ingest_workers:
        # the rung-5 pipelined path (DESIGN.md §22): pool workers ingest
        # trace segments ahead of a supervised stream engine
        return _run_pipelined_cli(ns, cfg, tr, device, mesh, rec)
    eng = StreamEngine(cfg, tr, window_events=ns.stream_window, device=device, mesh=mesh)
    if ns.attest == "chain":
        # window-scoped chain: the stream engine's natural chunk is the
        # window, so the cadence field is the window size
        from .attest import SoloAttest

        eng.attest = SoloAttest(ns.stream_window)
    if ns.overlap == "on":
        print(
            "overlap: the stream engine's next window is produced by "
            "the host fill/absorb cycle itself — nothing to "
            "speculate; running without overlap",
            file=sys.stderr,
        )
    eng.warmup()  # the kernels build before the clock starts
    _emit_ttfs_line(cache, t_start)
    if supervised:
        rc = _run_supervised(ns, cfg, eng, eng.device, rec=rec)
        _emit_exec_cache_line(cache, eng.device)
        return rc
    if rec is not None:
        rec.attach(eng)
    t0 = time.perf_counter()
    eng.run(max_steps=ns.max_steps)  # None: the event-count budget
    wall = time.perf_counter() - t0
    _emit_summary(
        ns, cfg, eng.counters, eng.cycles, wall,
        {"device": str(eng.device), "steps": eng.steps_run, **_attest_extra(eng)},
        timeline=rec.timeline_summary() if rec is not None else None,
    )
    _emit_exec_cache_line(cache, eng.device)
    _finalize_obs(rec)
    return 0


def _run_pipelined_cli(ns, cfg, tr, device, mesh, rec) -> int:
    """`run --stream-window W --ingest-workers K`: the pipelined rung-5
    path (DESIGN.md §22). Pool ingest workers materialize trace segments
    ahead of a supervised PipelineStreamEngine in THIS process; the
    supervisor contract (checkpoints/resume/guard/preemption) is the
    stream engine's, unchanged."""
    from .ingest.pipeline import run_pipelined
    from .sim.supervisor import Preempted

    traces = ns.trace or []
    if len(traces) + (1 if ns.synth else 0) != 1:
        raise SystemExit(
            "--ingest-workers needs exactly one --trace file or one "
            "--synth spec (workers re-materialize the source from its "
            "portable spec)"
        )
    if traces and ns.fold:
        raise SystemExit(
            "--ingest-workers does not compose with --fold for trace "
            "files yet (ingest workers re-read the raw file)"
        )
    trace_path = os.path.abspath(traces[0]) if traces else None
    sup_kwargs = dict(
        snapshot_dir=ns.checkpoint_dir,
        keep_snapshots=ns.keep_snapshots,
        checkpoint_every_chunks=ns.checkpoint_every,
        checkpoint_every_s=ns.checkpoint_wall,
        guard=ns.guard,
        max_retries=ns.max_retries,
        obs=rec,
    )
    t0 = time.perf_counter()
    try:
        eng, sup, ingest = run_pipelined(
            cfg, tr,
            trace_path=trace_path,
            synth_spec=ns.synth if not traces else None,
            window_events=ns.stream_window,
            seg_events=ns.seg_events or None,
            ingest_workers=ns.ingest_workers,
            pool_dir=ns.pool_dir,
            device=device,
            mesh=mesh,
            supervisor_kwargs=sup_kwargs,
            max_steps=ns.max_steps,
            resume=bool(ns.resume),
            obs=rec,
            log=lambda m: print(f"run: {m}", file=sys.stderr),
        )
    except Preempted as e:
        _finalize_obs(rec)
        return _emit_preempted(e, e.supervisor)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "metric": "ingest_pipeline",
        "value": ingest["segments"],
        "unit": "segments",
        "detail": ingest,
    }))
    for line in sup.log_lines():
        print(f"supervisor: {line}", file=sys.stderr)
    _emit_summary(
        ns, cfg, eng.counters, eng.cycles, wall,
        {"device": str(eng.device), "steps": eng.steps_run, **sup.summary()},
        timeline=rec.timeline_summary() if rec is not None else None,
    )
    _finalize_obs(rec)
    return 0


def cmd_capture(ns) -> int:
    """Execution-driven simulation of a real binary: run the target under
    the LD_PRELOAD capture shim and either simulate it ONLINE while it
    executes (the default, through shared-memory rings) or write a PTPU
    trace for later replay (--out)."""
    cfg = _load_config(ns.config)
    if ns.out:
        if ns.report:
            raise SystemExit(
                "--report needs a simulation: drop --out for online mode, "
                "or replay the trace with `primetpu run --trace`"
            )
        from .ingest.capture import capture_run

        try:
            tr = capture_run(ns.command, line=cfg.l1.line)
        except RuntimeError as e:
            print(f"capture failed: {e}", file=sys.stderr)
            return 1
        tr.save(ns.out)
        print(
            f"wrote {ns.out}: {tr.n_cores} cores x {tr.max_len} events",
            file=sys.stderr,
        )
        return 0

    from .ingest.capture import capture_online
    from .ingest.ring import OnlineEngine
    from .sim.engine import resolve_device

    device = resolve_device(ns.device)  # before the target starts
    proc, src = capture_online(
        ns.command, n_cores=cfg.n_cores, line=cfg.l1.line, retain_history=False,
    )
    try:
        eng = OnlineEngine(cfg, src, window_events=ns.window, device=device)
        eng.warmup()  # the kernels build before the clock starts
        t0 = time.perf_counter()
        eng.run()
        wall = time.perf_counter() - t0
        rc = proc.wait(timeout=30)
        if rc != 0:
            print(f"target exited {rc}", file=sys.stderr)
        if src.dropped():
            print(
                f"WARNING: {src.dropped()} events dropped on full rings",
                file=sys.stderr,
            )
        _emit_summary(
            ns, cfg, eng.counters, eng.cycles, wall,
            {"events": int(src.total.sum()), "target_rc": rc,
             "device": str(device), "steps": eng.steps_run},
            engine="online",
        )
        return 0
    finally:
        if proc.poll() is None:
            proc.kill()
        src.close()


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

    t_start = time.perf_counter()  # time_to_first_step's epoch
    if ns.fork_prefix not in ("auto", "off"):
        try:
            int(ns.fork_prefix)
        except ValueError:
            raise SystemExit(
                f"sweep: --fork-prefix must be auto, off, or an integer "
                f"step cap (got {ns.fork_prefix!r})"
            ) from None
    cache = _activate_exec_cache(ns)
    cfg = _apply_faults(ns, _apply_step_impl(ns, _load_config(ns.config)))
    _check_supervision_flags(ns)
    _configure_disk(ns)
    if ns.workers:
        # elastic pool path (DESIGN.md §17): coordinator in-process, N
        # worker subprocesses leasing units over the serve protocol
        from .pool.campaign import run_pooled_sweep

        return run_pooled_sweep(ns, cfg)
    if ns.report:
        raise SystemExit(
            "sweep: --report is the pooled campaign report (--workers); "
            "use --report-dir for per-element reports"
        )

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
    mesh = _build_mesh(ns, cfg, device)
    if device.type == "cuda":
        build.libraries(build.KERNELS)  # build or load before the clock starts
    if ns.strict:
        traces = [s() if callable(s) else s for s in sources]
        fleet = FleetEngine(cfg, traces, ovs, chunk_steps=ns.chunk_steps, device=device,
                            mesh=mesh)
        quarantined: list = []
    else:
        fleet, quarantined = build_fleet_isolated(
            cfg, sources, ovs, chunk_steps=ns.chunk_steps, device=device, mesh=mesh
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
                chunk_steps=ns.chunk_steps, device=device, mesh=mesh,
            )
            fleet.element_ids = kept_ids
    _emit_ttfs_line(cache, t_start)
    fleet.overlap = ns.overlap == "on"
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
    _emit_exec_cache_line(cache, device)
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


def cmd_worker(ns) -> int:
    """Pool worker process (DESIGN.md §17): lease work units from a
    coordinator, simulate them under per-unit element checkpoints and
    heartbeats, ack results. Normally spawned BY a pooled sweep, a
    dispatching daemon or a pipelined run; running one by hand joins an
    in-flight campaign (that is the elastic part)."""
    from .pool.worker import run_worker

    _configure_disk(ns)
    _activate_exec_cache(ns)  # every kernel load of the worker consults it
    return run_worker(
        ns.connect,
        ns.worker_id,
        warm_cache=ns.warm_cache == "on",
        reconnect_timeout_s=ns.reconnect_timeout,
        crash_after_chunks=ns.crash_after_chunks,
        idle_exit_s=ns.idle_exit,
        device=ns.device,
        overlap=ns.overlap == "on",
    )


def cmd_coordinator(ns) -> int:
    """Standalone dynamic-mode pool coordinator (DESIGN.md §18): the
    lease/heartbeat/ack bookkeeper for an elastic serving fleet.
    Normally spawned by `serve --pool-dir`; run by hand for a shared
    pool several front-ends dispatch into. SIGTERM/SIGINT close the
    socket and flush the unit ledger; kill -9 at any instant is
    recoverable — restarting over the same --pool-dir replays every
    enqueued unit, adopts acked results, and re-adopts live worker
    leases by heartbeat epoch. It simulates nothing and touches no
    device."""
    import signal as _signal

    from .pool.coordinator import PoolCoordinator
    from .serve.protocol import socket_alive

    sock = ns.socket or os.path.join(ns.pool_dir, "pool.sock")
    if socket_alive(sock):
        # Probe BEFORE constructing: __init__ replays the shared ledger
        # and journals a recovery note, which a losing standby must not
        # spam into the live coordinator's journal.
        print(
            f"coordinator: a live coordinator already owns {sock}",
            file=sys.stderr,
        )
        return 1

    rec = _build_recorder(ns)
    coord = PoolCoordinator(
        [],
        pool_dir=ns.pool_dir,
        socket_path=ns.socket,
        lease_ttl_s=ns.lease_ttl,
        poison_threshold=ns.poison_threshold,
        hedge=ns.hedge == "on",
        obs=rec,
        dynamic=True,
        attest=ns.attest,
        audit_rate=ns.audit_rate,
    )
    try:
        coord.start()
    except RuntimeError as e:  # lost the bind race to another standby
        print(f"coordinator: {e}", file=sys.stderr)
        return 1
    pid_path = os.path.join(ns.pool_dir, "coordinator.pid")
    with open(pid_path, "w") as f:
        f.write(str(os.getpid()))
    stop = {"flag": False}

    def _term(signum, frame):
        stop["flag"] = True

    try:
        _signal.signal(_signal.SIGTERM, _term)
        _signal.signal(_signal.SIGINT, _term)
    except ValueError:
        pass
    r = coord.recovered
    print(
        f"coordinator: listening on {coord.socket_path} "
        f"(recovered units={r.get('units_respawned', 0)} "
        f"results={r.get('results_adopted', 0)} "
        f"leases={r.get('leases_readopted', 0)})",
        file=sys.stderr,
    )
    try:
        while not stop["flag"]:
            coord.tick()
            time.sleep(0.2)
    finally:
        coord.close()
        try:
            os.unlink(pid_path)
        except OSError:
            pass
        _finalize_obs(rec)
        print(
            f"coordinator: closed ({json.dumps(coord.pool_report())})",
            file=sys.stderr,
        )
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


def _parse_buckets(spec: str):
    """'SLOTSxPAGES[,SLOTSxPAGES...]' -> ((slots, pages), ...): the
    serving fleet's paged capacity ladder (serve/scheduler.py)."""
    out = []
    for part in spec.split(","):
        s, x, p = part.partition("x")
        if not x or not s.isdigit() or not p.isdigit() \
                or int(s) < 1 or int(p) < 1:
            raise SystemExit(
                f"bad --buckets entry {part!r} (want SLOTSxPAGES, e.g. 6x1)"
            )
        out.append((int(s), int(p)))
    return tuple(out)


def cmd_serve(ns) -> int:
    """Start the continuous-batching simulation daemon (DESIGN.md §14):
    one fleet per capacity bucket on the device, jobs spliced into slots
    as elements retire, WAL-journaled so kill -9 loses nothing. SIGTERM
    drains (checkpoint + exit 75 when work remains); SIGHUP reloads
    --config's fault schedule (same geometry only)."""
    from .kernels import build
    from .serve.quota import TenantQuota
    from .serve.server import PrimeServer
    from .sim.engine import resolve_device

    cfg = _apply_faults(ns, _apply_step_impl(ns, _load_config(ns.config)))
    _configure_disk(ns)
    # the buckets' kernel loads (and, in dispatch mode, the autoscaled
    # workers' argv) consult the process-global kernel build cache
    _activate_exec_cache(ns)
    rec = _build_recorder(ns)
    if ns.tcp and ns.socket:
        raise SystemExit("--tcp and --socket are mutually exclusive")
    if ns.devices and not ns.pool_dir:
        raise SystemExit(
            "serve: --devices needs dispatch mode (--pool-dir): sharded "
            "fleets live on pool workers, not in the front-end process"
        )
    device = resolve_device(ns.device)
    if ns.devices:
        from .parallel.sharding import validate_devices

        validate_devices(cfg, ns.devices, "gpu" if device.type == "cuda" else "cpu")
    if device.type == "cuda" and not ns.pool_dir:
        build.libraries(build.KERNELS)  # build or load before the first job
    replicas = [t.strip() for t in (ns.replicas or "").split(",")
                if t.strip()]
    if ns.standby_of:
        # hot standby (DESIGN.md §21): tail the replicas while the
        # incumbent lives; once it stays dead past the grace window,
        # adopt the highest-epoch replica chain and fall through to serve
        # as the new primary — whose begin_epoch() fences the old one
        if not replicas:
            raise SystemExit("--standby-of requires --replicas")
        from .serve.replicate import Standby

        sb = Standby(ns.standby_of, replicas, ns.state_dir,
                     grace_s=ns.takeover_grace)
        print(
            f"serve: standby of {ns.standby_of} "
            f"(replicas={','.join(replicas)}, "
            f"grace={ns.takeover_grace}s)",
            file=sys.stderr, flush=True,
        )
        report = sb.wait_for_takeover()
        print(
            f"serve: PROMOTING — adopted chain from {report['source']} "
            f"(tip seq={report['tip']['seq']}, "
            f"{report['reachable']} replica(s) reachable)",
            file=sys.stderr, flush=True,
        )
    server = PrimeServer(
        cfg,
        state_dir=ns.state_dir,
        socket_path=ns.tcp or ns.socket,
        buckets=_parse_buckets(ns.buckets),
        chunk_steps=ns.chunk_steps,
        max_queue=ns.max_queue,
        checkpoint_every_s=ns.checkpoint_wall,
        config_path=ns.config,
        idle_exit_s=ns.idle_exit,
        obs=rec,
        warm_cache=ns.warm_cache == "on",
        quota=TenantQuota.parse(ns.quota) if ns.quota else None,
        attest=ns.attest,
        device=device,
        pool_dir=ns.pool_dir,
        max_workers=ns.workers,
        lease_ttl_s=ns.lease_ttl,
        audit_rate=ns.audit_rate,
        replicas=replicas or None,
        quorum=ns.quorum,
        quorum_policy=ns.quorum_policy,
        devices=ns.devices,
    )
    # bind before the readiness line so `--tcp HOST:0` prints the real
    # kernel-assigned port (tests and scripts scrape this line)
    target = server.bind()
    mode = f"dispatch->{ns.pool_dir}" if ns.pool_dir else "local"
    if server.repl is not None:
        mode += (f", replicated x{len(server.repl.links)} "
                 f"quorum={server.repl.quorum} "
                 f"epoch={server.repl.epoch}")
    print(
        f"serve: listening on {target} ({mode}, "
        f"recovered={server.recovered['jobs_requeued']} job(s))",
        file=sys.stderr, flush=True,
    )
    rc = server.serve_forever()
    if ns.report:
        import numpy as np

        from .stats.counters import COUNTER_NAMES
        from .stats.report import write_report

        # the aggregate SERVICE report: per-core counter/cycle axes are
        # not meaningful across heterogeneous jobs, so they render zero
        # and the SERVICE section carries the data
        write_report(
            ns.report, cfg,
            {k: np.zeros(cfg.n_cores, np.int64) for k in COUNTER_NAMES},
            np.zeros(cfg.n_cores, np.int64),
            title="primetpu serve",
            service=server.sched.service_report(),
            timeline=rec.timeline_summary() if rec is not None else None,
        )
        print(f"report written to {ns.report}", file=sys.stderr)
    _finalize_obs(rec)
    print(
        f"serve: drained rc={rc} "
        f"({json.dumps(server.sched.service_report())})",
        file=sys.stderr,
    )
    return rc


def cmd_replica(ns) -> int:
    """Run one journal follower (DESIGN.md §21): a byte-blind segment
    store behind a `repl.*` listener. Point a primary's `--replicas` at
    it; a standby promotes from it. SIGTERM stops cleanly — the chain
    on disk IS the durable state, there is nothing to drain. It touches
    no device."""
    import signal as _signal

    from .serve.replicate import ReplicaServer

    if ns.tcp and ns.socket:
        raise SystemExit("--tcp and --socket are mutually exclusive")
    server = ReplicaServer(ns.dir, ns.tcp or ns.socket
                           or os.path.join(ns.dir, "replica.sock"))
    target = server.bind()
    tip = server.store.tip()
    print(
        f"replica: listening on {target} (dir={ns.dir}, "
        f"epoch={server.epoch}, tip seq={tip['seq']})",
        file=sys.stderr, flush=True,
    )

    def _stop(signum, frame):
        server.die()

    try:
        _signal.signal(_signal.SIGTERM, _stop)
        _signal.signal(_signal.SIGINT, _stop)
    except ValueError:
        pass
    server.serve_forever()
    server.shutdown()
    return 0


def cmd_fsck(ns) -> int:
    """Verify the durable artifacts under DIR (journals, ledgers,
    checkpoints, warm and executable cache entries) with no simulation,
    or with --compare hold two journal chains to frame-for-frame
    agreement. Exit 0 clean (notes allowed), 2 with one structured JSON
    line on corruption. It touches no device."""
    from .analysis.errors import FsckCorrupt
    from .analysis.fsck import (render_human, render_json, run_compare,
                                run_fsck)

    if ns.compare:
        res = run_compare(ns.compare[0], ns.compare[1])
        where = res.root
    else:
        if not ns.dir:
            raise FsckCorrupt("fsck needs DIR (or --compare DIR_A DIR_B)")
        res = run_fsck(ns.dir, repair=ns.repair)
        where = ns.dir
    if ns.format == "json":
        print(render_json(res))
    else:
        print(render_human(res))
    if not res.clean:
        first = res.corrupt[0]
        raise FsckCorrupt(
            f"{len(res.corrupt)} corrupt artifact finding(s) under "
            f"{where} (first: {first.path}: {first.detail})",
            path=first.path, n_corrupt=len(res.corrupt),
        )
    return 0


def _load_kernels(device) -> None:
    """On a card, build and load every kernel before the first dispatch
    and count launches from 0 (the port's stderr line reports them)."""
    from .kernels import build

    if device.type == "cuda":
        build.libraries(build.KERNELS)
    build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))


def cmd_audit(ns) -> int:
    """Offline replay audit (DESIGN.md §24): re-execute a pool
    campaign's DONE units from their journaled specs on the device and
    compare the recomputed fingerprint-chain heads against the ledger's
    acked heads, its retained evidence and the surviving element
    checkpoints. One JSON verdict line per unit on stdout, `primetpu
    audit`'s summary line on stderr, then the port's own line: the
    device, each replay's wall and the kernel launches."""
    from .attest.audit import run_audit
    from .attest.errors import AttestationError
    from .kernels import build
    from .sim.engine import resolve_device

    device = resolve_device(ns.device)
    _load_kernels(device)  # before the first replay
    res = run_audit(ns.dir, unit_ids=ns.unit, device=device)
    for v in res["units"]:
        print(json.dumps(v))
    s = res["summary"]
    print(
        f"audit: {s['audited']} unit(s) replayed — {s['ok']} ok, "
        f"{s['mismatch']} mismatch, {s['adjudicated']} adjudicated, "
        f"{s['incomparable']} incomparable, {s['skipped']} skipped",
        file=sys.stderr,
    )
    print(
        f"audit: device {device}, " + json.dumps(
            {"replay_wall_s": res["replay_wall_s"],
             "launches": dict(build.LAUNCHES)}),
        file=sys.stderr, flush=True,
    )
    if s["mismatch"]:
        first = next(v for v in res["units"] if v["status"] == "mismatch")
        raise AttestationError(
            f"{s['mismatch']} unit(s) fail offline replay audit under "
            f"{ns.dir} (first: {first['unit_id']})",
            site="audit.replay", unit=first["unit_id"],
        )
    return 0


def cmd_calibrate(ns) -> int:
    """Fit timing knobs to a published microbenchmark table (DESIGN.md
    §25): coordinate-descent pattern search where every candidate set
    runs as ONE constant-shape fleet on the device. Emits `primetpu
    calibrate`'s lines: one `calibrate_residual` JSON line per table
    entry plus a final `calibrate_fit` line; `--selftest` replaces the
    observed column with values simulated at ground-truth knobs and
    asserts the fit recovers them (exit 1 if not). Then the port's own
    stderr line: the device, the fit's fleet dispatches, fleet steps and
    retired instructions, the kernel launches it made and its wall."""
    from .calib.fit import (
        FIT_KEYS_DEFAULT, _FleetEvaluator, apply_fit, build_traces,
        check_fit_keys, fit, knob_start, synthesize_observed,
    )
    from .calib.table import load_table
    from .kernels import build
    from .sim.engine import resolve_device

    cfg = _load_config(ns.config)
    table = load_table(ns.table)
    fit_keys = (
        check_fit_keys(k.strip() for k in ns.fit.split(","))
        if ns.fit else FIT_KEYS_DEFAULT
    )
    device = resolve_device(ns.device)
    _load_kernels(device)
    truth = None
    if ns.selftest:
        # ground truth: explicit --truth overrides, else a deterministic
        # perturbation of the config's own knobs (so the search must
        # genuinely move to recover them)
        truth = (
            {k: int(v) for k, v in _parse_vary(ns.truth).items()}
            if ns.truth
            else {
                k: v + max(1, v // 2)
                for k, v in knob_start(cfg, fit_keys).items()
            }
        )
        check_fit_keys(truth.keys())
        table = synthesize_observed(
            cfg, table, truth, chunk_steps=ns.chunk_steps, device=device
        )
    ev = _FleetEvaluator(cfg, table, build_traces(cfg, table),
                         ns.chunk_steps, device)
    build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))
    t0 = time.perf_counter()
    res = fit(
        cfg, table, fit_keys=fit_keys, max_rounds=ns.rounds,
        chunk_steps=ns.chunk_steps,
        log=(lambda s: print(f"calibrate: {s}", file=sys.stderr))
        if ns.verbose else None,
        evaluator=ev,
    )
    wall = time.perf_counter() - t0
    for name, sim, obs, r in res.residuals:
        print(
            json.dumps(
                {
                    "metric": "calibrate_residual",
                    "value": round(r, 6),
                    "unit": "relative",
                    "detail": {
                        "entry": name,
                        "simulated": round(sim, 4),
                        "observed": round(obs, 4),
                        "table": table.name,
                    },
                }
            )
        )
    detail = {
        "table": table.name,
        "fit_keys": list(fit_keys),
        "knobs": res.knobs,
        "start": res.start,
        "rounds": res.rounds,
        "fleet_runs": res.fleet_runs,
        "batch": res.batch,
        "wall_s": round(wall, 3),
    }
    if truth is not None:
        detail["truth"] = truth
        # exact knob equality is informational (latency knobs can trade
        # off degenerately, e.g. link vs router on fixed-hop entries);
        # the self-test CONTRACT is ~zero residual at the fitted point
        detail["recovered"] = all(
            res.knobs[k] == v for k, v in truth.items()
        )
        detail["selftest_ok"] = res.cost <= ns.tol
    print(
        json.dumps(
            {
                "metric": "calibrate_fit",
                "value": round(res.cost, 8),
                "unit": "sum_sq_rel_residual",
                "detail": detail,
            }
        )
    )
    if ns.out:
        report = res.report()
        report["table"] = table.name
        report["config"] = apply_fit(cfg, res.knobs).to_json()
        if truth is not None:
            report["truth"] = truth
        with open(ns.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"calibration report written to {ns.out}", file=sys.stderr)
    print(
        f"calibrate: device {device}, " + json.dumps(
            {"fleet_runs": ev.runs, "fleet_steps": ev.steps,
             "instructions": ev.instructions,
             "launches": dict(build.LAUNCHES), "wall_s": wall}),
        file=sys.stderr, flush=True,
    )
    if truth is not None and not detail["selftest_ok"]:
        print(
            f"calibrate: SELFTEST FAILED — residual cost {res.cost:.3g} "
            f"> tol {ns.tol:.3g} (truth {truth}, fitted "
            f"{ {k: res.knobs[k] for k in truth} })",
            file=sys.stderr,
        )
        return 1
    return 0


def cmd_chaos(ns) -> int:
    """Seeded crash campaign (DESIGN.md §20): N trials of the serve
    stack on the device under generated fault plans, invariants
    machine-checked after each; violations shrink to a minimal
    replayable artifact. Exit 0 clean, 3 on any violation. After
    `primetpu chaos`'s output, the port's stderr line: the device, the
    campaign's wall and the kernel launches its trials made."""
    from .chaos import campaign as C
    from .kernels import build
    from .sim.engine import resolve_device

    cfg = _load_config(ns.config) if ns.config else None
    device = resolve_device(ns.device)
    _load_kernels(device)
    t0 = time.perf_counter()

    def device_line():
        print(
            f"chaos: device {device}, " + json.dumps(
                {"launches": dict(build.LAUNCHES),
                 "wall_s": time.perf_counter() - t0}),
            file=sys.stderr, flush=True,
        )

    if ns.plan:
        res = C.replay_artifact(ns.plan, cfg=cfg, device=device)
        print(json.dumps(res.as_dict(), indent=2, sort_keys=True))
        device_line()
        return 0 if res.ok else 3

    def progress(seed, res):
        if ns.verbose:
            print(
                f"trial seed={seed} "
                f"{'ok' if res.ok else 'VIOLATION'} "
                f"fired={len(res.injected)} restarts={res.restarts}",
                file=sys.stderr,
            )

    report = C.run_campaign(
        n_trials=ns.trials,
        seed0=ns.seed,
        classes=tuple(ns.classes.split(",")),
        cfg=cfg,
        artifact_dir=ns.out,
        max_events=ns.max_events,
        progress=progress,
        device=device,
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    device_line()
    return 0 if report["ok"] else 3


def cmd_submit(ns) -> int:
    """Submit one job to a running daemon; with --wait, block for the
    terminal state and print the full result record."""
    from .serve.client import ServeClient, ServeError

    cli = ServeClient(ns.socket)
    overrides = {}
    for spec in ns.vary or []:
        overrides.update(_parse_vary(spec))
    try:
        job = cli.submit(
            trace_path=ns.trace,
            synth=ns.synth,
            overrides=overrides,
            fold=ns.fold,
            deadline_s=ns.deadline,
            max_steps=ns.max_steps or 10_000_000,
            priority=ns.priority,
            client=ns.client,
            retries=ns.retries,
        )
        if ns.wait:
            job = cli.wait(job["job_id"], timeout_s=ns.timeout)
    except ServeError as e:
        out = {"ok": False, "error": e.error}
        if e.retry_after_s is not None:
            out["retry_after_s"] = e.retry_after_s
        print(json.dumps(out))
        return 4 if e.retry_after_s is not None else 1
    except OSError as e:
        from .serve.protocol import error_obj

        print(json.dumps({"ok": False, **error_obj(e)}))
        return 1
    print(json.dumps({"ok": True, "job": job}))
    if ns.wait and job["state"] != "DONE":
        return 1
    return 0


def _watch_line(h: dict) -> str:
    """One live status line from a health reply (serve-status --watch)."""
    jobs = h.get("jobs", {})
    slots = h.get("slots", {})
    lat = h.get("latency_s") or {}
    age = h.get("last_dispatch_age_s")
    parts = [
        time.strftime("%H:%M:%S"),
        f"q={h.get('queue_depth', 0)}",
        f"slots={slots.get('occupied', 0)}/{slots.get('total', 0)}",
        f"run={jobs.get('RUNNING', 0)}",
        f"done={h.get('completed', 0)}",
        f"mips={h.get('aggregate_mips', 0.0)}",
        f"p50={lat.get('p50') if lat.get('p50') is not None else '-'}",
        f"disp={f'{age}s ago' if age is not None else 'never'}",
        f"up={h.get('uptime_s', 0)}s",
    ]
    if h.get("draining"):
        parts.append("DRAINING")
    return "  ".join(parts)


def cmd_serve_status(ns) -> int:
    """Query a running daemon: health (default), --jobs listing,
    --metrics (Prometheus text), --watch (live one-line refresh), or
    --drain (ask it to finish the queue and exit)."""
    from .serve.client import ServeClient, ServeError

    cli = ServeClient(ns.socket)
    try:
        if ns.drain:
            print(json.dumps(cli.drain()))
        elif ns.jobs:
            print(json.dumps(cli.status()))
        elif ns.metrics:
            sys.stdout.write(cli.metrics())
        elif ns.watch:
            from .util.backoff import DecorrelatedJitter

            n = 0
            down_since = None
            failed_polls = 0
            jit = DecorrelatedJitter(base=min(ns.interval, 0.5),
                                     cap=max(ns.interval * 4, 2.0))
            while True:
                # a dead target prints DOWN and keeps watching under
                # jittered backoff (the daemon may be mid-restart)
                try:
                    line = _watch_line(cli.health())
                    if down_since is not None:
                        line += (
                            f"  [RECOVERED after "
                            f"{time.monotonic() - down_since:.1f}s "
                            f"({failed_polls} failed poll(s)) "
                            f"via {cli.target}]"
                        )
                        down_since = None
                        failed_polls = 0
                        jit.reset()
                except (ServeError, OSError) as e:
                    down_since = down_since or time.monotonic()
                    failed_polls += 1
                    line = (
                        f"{time.strftime('%H:%M:%S')}  "
                        f"DOWN {cli.target} ({type(e).__name__})"
                    )
                print(line, flush=True)
                n += 1
                if ns.count and n >= ns.count:
                    break
                time.sleep(jit.next_delay() if down_since is not None
                           else ns.interval)
        else:
            print(json.dumps(cli.health()))
    except KeyboardInterrupt:
        return 0
    except ServeError as e:
        print(json.dumps({"ok": False, "error": e.error}))
        return 1
    except OSError as e:
        from .serve.protocol import error_obj

        print(json.dumps({"ok": False, **error_obj(e)}))
        return 1
    return 0


def _add_shared_flags(sp, resilience: bool = True) -> None:
    """run's and sweep's (and, but for the resilience flags, serve's)
    fault, telemetry, cache-budget and device flags."""
    sp.add_argument(
        "--fault-schedule", metavar="FILE",
        help="JSON fault schedule (events, flip and DUE rates, policies); "
             "arms the deterministic fault model (DESIGN.md §12)",
    )
    sp.add_argument(
        "--fault-seed", type=int, default=None, metavar="N",
        help="seed of the counter-based fault PRNG (default 0)",
    )
    _add_obs_flags(sp)
    _add_cache_budget_flag(sp)
    sp.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="default: cuda (an error when there is no card)",
    )
    if resilience:
        _add_resilience_flags(sp)


def _add_cache_budget_flag(sp) -> None:
    sp.add_argument(
        "--cache-budget", type=int, default=None, metavar="BYTES",
        help="shared byte budget of the governed artifact pool (the "
             "warm-state cache and the kernel build cache; DESIGN.md §26): "
             "LRU pruning and the disk-pressure evict ladder both honor it; "
             "takes precedence over $PRIMETPU_CACHE_MAX_BYTES (default: env "
             "var, then 2 GiB)",
    )


def _add_exec_flags(sp, overlap: bool = True) -> None:
    """run's, sweep's and worker's (serve's without --overlap) build-once
    and overlap flags, `primetpu`'s choices and defaults: both off, and
    off prints exactly what the port printed without them."""
    sp.add_argument(
        "--exec-cache", choices=("on", "off"), default="off",
        help="consult and populate the kernel build cache "
             "($PRIMETPU_CACHE_DIR/exec): a warm process loads the kernel "
             "libraries instead of running nvcc; corrupt or stale entries "
             "degrade to a rebuild",
    )
    if overlap:
        sp.add_argument(
            "--overlap", choices=("on", "off"), default="off",
            help="overlapped chunk dispatch: enqueue chunk k+1 before the "
                 "host's work on chunk k (journal, checkpoint write, chain, "
                 "obs commit), on a copy of the committed state; bit-exact",
        )


def _add_obs_flags(sp) -> None:
    """The telemetry flags (`obs.Recorder`): run's, sweep's, serve's and
    the coordinator's."""
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


def _add_attest_flag(sp, audit: bool = False) -> None:
    sp.add_argument(
        "--attest", choices=("off", "chain"), default="off",
        help="result integrity (DESIGN.md §24): fingerprint-chain every "
             "committed chunk (default off — bit-exact with today); with "
             "a pool, compare hedged-twin results and verify worker "
             "toolchains at lease grant",
    )
    if audit:
        sp.add_argument(
            "--audit-rate", type=float, default=0.0, metavar="P",
            help="(--attest chain, a pool) re-dispatch this fraction of "
                 "DONE units to a different worker and compare chain "
                 "heads (deterministic per-unit sampling; default 0)",
        )


def _add_pool_flags(sp, poison_threshold: int) -> None:
    """The lease flags of a pool's coordinator (`sweep --workers`, the
    `coordinator` verb)."""
    sp.add_argument(
        "--lease-ttl", type=float, default=10.0, metavar="SEC",
        help="lease deadline; a worker missing heartbeats this long is "
             "presumed dead and its unit re-dispatches (default 10)",
    )
    sp.add_argument(
        "--poison-threshold", type=int, default=poison_threshold,
        metavar="K",
        help="quarantine a unit after its lease expired under K DISTINCT "
             f"workers (default {poison_threshold})",
    )
    sp.add_argument(
        "--hedge", choices=("on", "off"), default="on",
        help="near campaign end, speculatively re-dispatch the slowest "
             "in-flight unit to an idle worker; first ack wins (default on)",
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
    r.add_argument(
        "--stream-window", type=int, default=0, metavar="N",
        help="stream the trace through N-event windows (bounded device "
             "memory; bit-exact vs preloaded; for traces larger than the "
             "card's memory)",
    )
    r.add_argument(
        "--mmap", action="store_true",
        help="memory-map the trace file (pair with --stream-window for "
             "traces larger than host memory)",
    )
    r.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="shard the simulated machine over the first N devices "
             "(cores/L1s by core, LLC/directory by bank; on the CPU the "
             "devices are XLA_FLAGS=--xla_force_host_platform_device_"
             "count's)",
    )
    r.add_argument(
        "--ingest-workers", type=int, default=0, metavar="K",
        help="(--stream-window) pipeline the window fill MPMD-style: K "
             "`python -m primesim_tpu_torch worker` processes ingest "
             "trace segments over the lease protocol, ahead of the "
             "(supervised) simulation in this process (DESIGN.md §22)",
    )
    r.add_argument(
        "--seg-events", type=int, default=0, metavar="L",
        help="(--ingest-workers) events/core per ingest segment "
             "(default: max(--stream-window, 4096))",
    )
    r.add_argument(
        "--pool-dir", default=None, metavar="DIR",
        help="(--ingest-workers) segment files + ingest lease ledger "
             "live here; re-running with the same DIR re-uses segments "
             "already ingested (default: a throwaway temp dir)",
    )
    _add_attest_flag(r)
    _add_shared_flags(r)
    _add_exec_flags(r)
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
    w.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="shard EVERY fleet element over the first N devices (shard "
             "x vmap, DESIGN.md §22: cores/L1s by core, LLC/directory by "
             "bank, under the element batch); not yet with --workers",
    )
    w.add_argument(
        "--workers", type=int, default=0, metavar="N",
        help="run the sweep as an elastic pooled campaign: a lease-based "
             "coordinator plus N `python -m primesim_tpu_torch worker` "
             "processes sharing the card; a crashed worker's units "
             "re-dispatch and resume from their last checkpoint "
             "(DESIGN.md §17)",
    )
    w.add_argument(
        "--pool-dir", default=None, metavar="DIR",
        help="(--workers) lease ledger + per-unit checkpoints live here; "
             "restarting a killed campaign with the same DIR resumes it "
             "(default: a throwaway temp dir)",
    )
    _add_pool_flags(w, poison_threshold=2)
    w.add_argument(
        "--report", metavar="PATH",
        help="(--workers) write a text report with the POOL section",
    )
    _add_attest_flag(w, audit=True)
    _add_shared_flags(w)
    _add_exec_flags(w)
    w.set_defaults(fn=cmd_sweep)

    k = sub.add_parser(
        "worker",
        help="pool worker: lease work units from a coordinator socket "
             "(normally spawned by `sweep --workers`, `serve --pool-dir` "
             "or `run --ingest-workers`; run by hand to join a campaign)",
    )
    k.add_argument("--connect", required=True, metavar="SOCK",
                   help="coordinator socket (unix path or HOST:PORT)")
    k.add_argument("--worker-id", required=True, metavar="ID")
    k.add_argument(
        "--warm-cache", choices=("on", "off"), default="off",
        help="consult the on-disk warm-state cache for fresh units",
    )
    k.add_argument(
        "--reconnect-timeout", type=float, default=60.0, metavar="SEC",
        help="give up (exit 75) after the coordinator has been "
             "unreachable this long",
    )
    k.add_argument(
        "--crash-after-chunks", type=int, default=None,
        help=argparse.SUPPRESS,  # chaos-test hook: SIGKILL self at chunk N
    )
    k.add_argument(
        "--idle-exit", type=float, default=None, metavar="SEC",
        help="exit 0 after SEC seconds of continuous idle (no leases "
             "granted) — the elastic fleet's scale-down path",
    )
    k.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="where units simulate, resolved at the first one: cuda "
             "(default; no card is an error, never a run on the CPU)",
    )
    _add_exec_flags(k)
    _add_cache_budget_flag(k)
    k.set_defaults(fn=cmd_worker)

    co = sub.add_parser(
        "coordinator",
        help="standalone dynamic-mode pool coordinator for an elastic "
             "serving fleet (normally spawned by `serve --pool-dir`; "
             "run by hand to share one pool across front-ends)",
    )
    co.add_argument(
        "--pool-dir", required=True, metavar="DIR",
        help="unit ledger + checkpoints + default socket live here; "
             "restarting with the same DIR replays every enqueued unit",
    )
    co.add_argument(
        "--socket", default=None, metavar="PATH|HOST:PORT",
        help="listen target (default: POOL_DIR/pool.sock; host:port "
             "listens on TCP, port 0 = kernel-assigned)",
    )
    _add_pool_flags(co, poison_threshold=3)
    _add_attest_flag(co, audit=True)
    _add_obs_flags(co)
    co.set_defaults(fn=cmd_coordinator)

    s = sub.add_parser("synth", help="generate a synthetic PTPU trace file")
    s.add_argument("spec", help="generator spec name[:k=v,...]")
    s.add_argument("--cores", type=int, required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--fold", action="store_true")
    s.set_defaults(fn=cmd_synth)

    c = sub.add_parser(
        "capture",
        help="run a pthread binary under the capture frontend and "
             "simulate it ONLINE (or write a trace with --out)",
    )
    c.add_argument("config", help="machine config (.json or .xml)")
    c.add_argument(
        "command", nargs="+",
        help="target command line (prefix with -- to separate flags)",
    )
    c.add_argument(
        "--out", help="write a PTPU trace instead of simulating online"
    )
    c.add_argument("--window", type=int, default=1024)
    c.add_argument("--report", help="write text report to this path")
    c.add_argument("--per-core-limit", type=int, default=64)
    c.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="default: cuda (an error when there is no card)",
    )
    c.set_defaults(fn=cmd_capture)

    i = sub.add_parser("info", help="parse + print a machine config")
    i.add_argument("config")
    i.set_defaults(fn=cmd_info)

    v = sub.add_parser(
        "serve",
        help="run the continuous-batching simulation daemon (jobs over a "
             "unix socket; WAL-journaled, crash-safe, drains on SIGTERM)",
    )
    v.add_argument("config", help="machine config (.json or .xml)")
    v.add_argument(
        "--state-dir", required=True, metavar="DIR",
        help="journal + per-job checkpoints + default socket live here; "
             "restarting with the same DIR resumes every unfinished job",
    )
    v.add_argument(
        "--socket", default=None, metavar="PATH",
        help="unix socket path (default: STATE_DIR/serve.sock)",
    )
    v.add_argument(
        "--tcp", default=None, metavar="HOST:PORT",
        help="listen on TCP instead of the unix socket (port 0 = "
             "kernel-assigned; the readiness line prints the real one)",
    )
    v.add_argument(
        "--pool-dir", default=None, metavar="DIR",
        help="dispatch mode: run jobs on an autoscaling pool of `python "
             "-m primesim_tpu_torch worker` processes over this pool "
             "directory (spawns a coordinator, or adopts one already "
             "listening — the standby-takeover path)",
    )
    v.add_argument(
        "--workers", type=int, default=2, metavar="N",
        help="dispatch mode: autoscale up to N worker processes "
             "(default 2)",
    )
    v.add_argument(
        "--lease-ttl", type=float, default=10.0, metavar="SEC",
        help="dispatch mode: pool lease TTL (default 10)",
    )
    v.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="dispatch mode: every leased unit runs on a fleet sharded "
             "over N devices (shard x vmap; the mesh shape joins the "
             "unit's geometry bucket)",
    )
    v.add_argument(
        "--quota", default=None, metavar="RATE[:BURST]",
        help="per-tenant admission quota: token bucket of RATE "
             "submits/sec (burst default max(1,RATE)) per client id; "
             "rejected submits get retry_after_s backpressure",
    )
    v.add_argument(
        "--buckets", default="6x1,2x8", metavar="SxP[,SxP...]",
        help="capacity ladder: SLOTSxPAGES per bucket, one fleet each, "
             "page = 64 event slots/core (default 6x1,2x8)",
    )
    v.add_argument("--chunk-steps", type=int, default=128)
    v.add_argument(
        "--max-queue", type=int, default=64, metavar="N",
        help="pending-queue bound; submits past it get RETRY_AFTER",
    )
    v.add_argument(
        "--checkpoint-wall", type=float, default=2.0, metavar="SEC",
        help="element-checkpoint in-flight jobs every SEC wall-seconds",
    )
    v.add_argument(
        "--idle-exit", type=float, default=None, metavar="SEC",
        help="exit 0 after SEC seconds with nothing queued or running "
             "(one-shot/CI mode; default: serve forever)",
    )
    v.add_argument(
        "--step-impl", choices=("xla", "pallas"), default=None,
        help="the JAX package's step implementation: recorded in the "
             "config; the port runs its own kernels",
    )
    v.add_argument(
        "--report", metavar="PATH",
        help="write a text report with the SERVICE section at drain",
    )
    v.add_argument(
        "--warm-cache", choices=("on", "off"), default="off",
        help="consult the on-disk warm-state cache at admission: a "
             "resubmitted (trace, config) job starts from the deepest "
             "matching cached state instead of step 0",
    )
    v.add_argument(
        "--replicas", default="", metavar="TARGET[,TARGET...]",
        help="replicate the journal to these follower daemons "
             "(`replica` targets, host:port or socket paths); "
             "'' (default) = replication off, bit-exact with today",
    )
    v.add_argument(
        "--quorum", type=int, default=None, metavar="K",
        help="replica ACKs required per frame (default: strict "
             "majority of the N replicas, N//2+1; any explicit K must "
             "satisfy 2K > N or quorums stop intersecting and fencing "
             "cannot be guaranteed)",
    )
    v.add_argument(
        "--quorum-policy", choices=("block", "degrade"), default="block",
        help="below quorum: block admission with ReplicaQuorumLost + "
             "retry_after_s (default), or degrade — keep ACKing on "
             "local fsync while flagging health/metrics",
    )
    v.add_argument(
        "--standby-of", default=None, metavar="TARGET",
        help="hot standby: tail --replicas while this primary target "
             "answers; once it stays dead past --takeover-grace, adopt "
             "the highest-epoch replica chain and promote (a fresh fencing "
             "epoch deposes the old primary)",
    )
    v.add_argument(
        "--takeover-grace", type=float, default=3.0, metavar="SEC",
        help="--standby-of: how long the primary must stay dead before "
             "promotion (default 3.0)",
    )
    _add_attest_flag(v, audit=True)
    _add_shared_flags(v, resilience=False)
    # no --overlap: the serving tick splices and retires slots between
    # chunks, so there is no next chunk to speculate
    _add_exec_flags(v, overlap=False)
    v.set_defaults(fn=cmd_serve)

    rp = sub.add_parser(
        "replica",
        help="run one journal follower for replicated serving "
             "(DESIGN.md §21): byte-identical segment chain, fsynced "
             "before ACK, fencing-epoch aware",
    )
    rp.add_argument(
        "--dir", required=True, metavar="DIR",
        help="this follower's journal directory (its durability domain)",
    )
    rp.add_argument(
        "--socket", default=None, metavar="PATH",
        help="unix socket to listen on (default: DIR/replica.sock)",
    )
    rp.add_argument(
        "--tcp", default=None, metavar="HOST:PORT",
        help="listen on TCP instead (port 0 = kernel-assigned; the "
             "readiness line prints the real one)",
    )
    rp.set_defaults(fn=cmd_replica)

    b = sub.add_parser(
        "submit",
        help="submit one job to a running `serve` daemon",
    )
    b.add_argument("--socket", required=True, metavar="PATH|HOST:PORT",
                   help="daemon target: unix socket path or TCP host:port")
    b.add_argument("--trace", help="PTPU trace file (server-side path)")
    b.add_argument("--synth", help="synthetic workload spec name[:k=v,...]")
    b.add_argument(
        "--vary", action="append", metavar="K=V[,K=V...]",
        help="timing overrides for this job (same keys as sweep --vary)",
    )
    b.add_argument("--fold", action="store_true")
    b.add_argument(
        "--deadline", type=float, default=None, metavar="SEC",
        help="wall-clock budget from acceptance; expiry -> TIMEOUT",
    )
    b.add_argument("--max-steps", type=int, default=None)
    b.add_argument("--priority", type=int, default=0)
    b.add_argument("--client", default="anon")
    b.add_argument(
        "--retries", type=int, default=0, metavar="N",
        help="honor RETRY_AFTER backpressure up to N resubmits",
    )
    b.add_argument(
        "--wait", action="store_true",
        help="block until the job is terminal; exit 0 only on DONE",
    )
    b.add_argument("--timeout", type=float, default=300.0, metavar="SEC")
    b.set_defaults(fn=cmd_submit)

    t = sub.add_parser(
        "serve-status",
        help="healthz for a running daemon (queue depth, occupancy, "
             "aggregate MIPS, latency percentiles)",
    )
    t.add_argument("--socket", required=True, metavar="PATH|HOST:PORT",
                   help="daemon target: unix socket path or TCP host:port")
    t.add_argument(
        "--jobs", action="store_true", help="list every known job instead"
    )
    t.add_argument(
        "--drain", action="store_true",
        help="ask the daemon to finish its queue and exit",
    )
    t.add_argument(
        "--metrics", action="store_true",
        help="print the daemon's Prometheus text exposition (the same "
             "payload the `metrics` protocol verb serves)",
    )
    t.add_argument(
        "--watch", action="store_true",
        help="poll health and print one live status line per interval "
             "(queue, occupancy, MIPS, latency p50, last dispatch)",
    )
    t.add_argument(
        "--interval", type=float, default=2.0, metavar="SEC",
        help="--watch poll interval (default 2.0)",
    )
    t.add_argument(
        "--count", type=int, default=0, metavar="N",
        help="--watch: stop after N lines (default 0 = forever)",
    )
    t.set_defaults(fn=cmd_serve_status)

    fk = sub.add_parser(
        "fsck",
        help="statically verify durable artifacts (journals, ledgers, "
             "checkpoints, warm cache) under a directory; exit 2 with "
             "structured JSON on corruption",
    )
    fk.add_argument("dir", metavar="DIR", nargs="?",
                    help="artifact root to verify")
    fk.add_argument(
        "--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
        help="instead of verifying one root, check two journal chains "
             "(primary vs replica) frame-for-frame up to the shorter "
             "one's durable point; divergence exits 2",
    )
    fk.add_argument(
        "--repair", choices=("none", "quarantine"), default="none",
        help="quarantine moves (never deletes) corrupt/orphaned files "
             "into DIR/.fsck-quarantine/",
    )
    fk.add_argument(
        "--format", choices=("human", "json"), default="human",
    )
    fk.set_defaults(fn=cmd_fsck)

    au = sub.add_parser(
        "audit",
        help="offline replay audit of a pool directory (DESIGN.md §24): "
             "re-execute DONE units from their journaled specs and "
             "compare fingerprint-chain heads against the ledger and "
             "the surviving checkpoints; exit 2 with structured JSON on "
             "divergence",
    )
    au.add_argument(
        "dir", metavar="DIR",
        help="pool directory (unit ledger + element checkpoints)",
    )
    au.add_argument(
        "--unit", action="append", metavar="ID",
        help="audit only this unit id (repeatable; default: every "
             "replayable unit)",
    )
    au.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="where the replays run (default: cuda, an error when there "
             "is no card)",
    )
    au.set_defaults(fn=cmd_audit)

    ch = sub.add_parser(
        "chaos",
        help="seeded crash campaign over the serve stack: generate "
             "fault plans, inject, machine-check durability invariants, "
             "shrink violations to a minimal repro artifact (DESIGN.md "
             "§20); exit 3 on violation",
    )
    ch.add_argument(
        "--trials", type=int, default=20,
        help="number of seeded trials (default 20)",
    )
    ch.add_argument(
        "--seed", type=int, default=0,
        help="first trial seed; trial k uses seed+k (default 0)",
    )
    ch.add_argument(
        "--classes", default="durable,crashpoint",
        help="comma list of fault classes to draw from: durable, "
             "crashpoint, socket, replication, silent_corruption, "
             "capacity_loss "
             "(default durable,crashpoint; replication runs the primary+"
             "replicas+standby failover trial and implies replica-kill "
             "crashpoints; silent_corruption flips committed counter "
             "bits on a pooled attested campaign and checks that no "
             "corrupted result reaches DONE unflagged; capacity_loss "
             "revokes devices from supervised runs (one card: nothing "
             "to take) and opens sustained-ENOSPC windows, checking "
             "invariant G — no ACKed job lost, no bit-exactness "
             "violation)",
    )
    ch.add_argument(
        "--max-events", type=int, default=3,
        help="max fault events per generated plan (default 3)",
    )
    ch.add_argument(
        "--out", default=None, metavar="DIR",
        help="write chaos-repro-<seed>.json artifacts here on violation",
    )
    ch.add_argument(
        "--plan", default=None, metavar="FILE",
        help="replay one plan/artifact JSON instead of generating "
             "(the repro loop)",
    )
    ch.add_argument(
        "--config", default=None,
        help="machine config JSON (default: small test config)",
    )
    ch.add_argument("--verbose", action="store_true",
                    help="per-trial progress on stderr")
    ch.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="where the trials simulate (default: cuda, an error when "
             "there is no card)",
    )
    ch.set_defaults(fn=cmd_chaos)

    ca = sub.add_parser(
        "calibrate",
        help="fit timing knobs to a published microbenchmark "
             "latency/bandwidth table (DESIGN.md §25): coordinate-"
             "descent pattern search run as constant-shape fleets",
    )
    ca.add_argument("config", help="machine config JSON/XML")
    ca.add_argument(
        "--table", required=True, metavar="FILE",
        help="calibration table JSON (e.g. "
             "configs/calib_ipu_microbench.json)",
    )
    ca.add_argument(
        "--fit", default=None, metavar="K1,K2,...",
        help="comma list of knobs to fit (default cpi,l1_lat,llc_lat,"
             "link_lat,router_lat,dram_lat)",
    )
    ca.add_argument(
        "--rounds", type=int, default=24,
        help="max coordinate-descent rounds (default 24)",
    )
    ca.add_argument(
        "--chunk-steps", type=int, default=256,
        help="fleet chunk size in steps (default 256)",
    )
    ca.add_argument(
        "--out", default=None, metavar="FILE",
        help="write the full fit report (knobs, residuals, fitted "
             "config) as JSON",
    )
    ca.add_argument(
        "--selftest", action="store_true",
        help="replace the observed column with values simulated at "
             "ground-truth knobs and require the fit to recover them "
             "with ~zero residual (exit 1 otherwise)",
    )
    ca.add_argument(
        "--truth", default=None, metavar="K=V,...",
        help="selftest ground-truth knobs (default: a deterministic "
             "perturbation of the config's own values)",
    )
    ca.add_argument(
        "--tol", type=float, default=1e-6,
        help="selftest pass threshold on the summed squared relative "
             "residual (default 1e-6)",
    )
    ca.add_argument("--verbose", action="store_true",
                    help="per-coordinate-step progress on stderr")
    ca.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="where the fleets run (default: cuda, an error when there "
             "is no card)",
    )
    ca.set_defaults(fn=cmd_calibrate)
    return p


def main(argv=None) -> int:
    # subprocess chaos activation: PRIMETPU_CHAOS_PLAN installs its plan
    # in this process (no-op when the variable is unset)
    from .chaos.sites import install_from_env

    install_from_env()
    ns = build_parser().parse_args(argv)
    from .analysis.errors import FsckCorrupt
    from .attest.errors import AttestationError
    from .calib.table import CalibError
    from .parallel.sharding import DeviceMeshError
    from .sim.checkpoint import CheckpointCorrupt

    try:
        return ns.fn(ns)
    except (TraceError, ConfigError, FaultConfigError, CheckpointCorrupt,
            VarySpecError, AttestationError, FsckCorrupt, CalibError,
            DeviceMeshError) as e:
        # typed errors exit 2 with ONE structured JSON line on stderr, as
        # `primetpu` prints them
        print(json.dumps(_error_obj(e)), file=sys.stderr)
        return 2
