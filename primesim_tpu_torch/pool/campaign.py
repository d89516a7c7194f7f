"""Pooled sweep campaign — `python -m primesim_tpu_torch sweep --workers N`
(DESIGN.md §17): the JAX package's `pool/campaign.py` for the port.

Runs the coordinator in-process and N `python -m primesim_tpu_torch
worker` subprocesses against its socket. The campaign loop only
bookkeeps: tick the coordinator (lease expiry), babysit the worker
processes, and emit the per-element JSON lines — in fleet-index order,
the JAX package's pooled sweep's lines — once every unit is DONE or
POISON.

The campaign resolves its device before it spawns anything: the workers
run on the card unless the sweep was given `--device cpu`, which they
are then given too; with no card and no `--device cpu` the sweep fails
at once (a worker would refuse to fall back to the CPU as well).

Worker deaths are NOT monitored through the process table: the lease
protocol is the failure detector, so a `kill -9`'d worker is detected by
its heartbeat going silent exactly like a worker on another machine
would be. The campaign watches pids for one thing only — LIVENESS: if
every worker is dead while units remain, it spawns a replacement (a
campaign must not hang because the OOM killer got lucky N times).

Chaos hook: PRIMETPU_POOL_CRASH="w0:3" makes worker w0 SIGKILL itself at
its 3rd committed chunk, as in the JAX package: the env var maps to the
worker's `--crash-after-chunks`, a one-event FaultPlan firing `kill` at
the Nth `worker.post-checkpoint` arrival. Richer fault schedules use
PRIMETPU_CHAOS_PLAN (a plan JSON path).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from .coordinator import PoolCoordinator
from .units import DONE, POISON, SUSPECT, build_units


def _fan_sources(ns):
    """The sweep fan rule (cli.cmd_sweep) applied to RAW specs: returns
    (trace_paths, synth_specs, overrides) already paired 1:1, traces
    ordered before synths — the same element order the in-process path
    produces, so per-element output lines up index for index."""
    from ..cli import _parse_vary

    traces = list(ns.trace or [])
    synths = list(ns.synth or [])
    if not traces and not synths:
        raise SystemExit("sweep: need --trace FILE and/or --synth SPEC")
    ovs = [_parse_vary(s) for s in (ns.vary or [])]
    A, V = len(traces) + len(synths), len(ovs)
    if V == 0:
        ovs = [{}] * A
    elif A == 1 and V > 1:
        traces, synths = traces * V, synths * V
    elif V == 1 and A > 1:
        ovs = ovs * A
    elif A != V:
        raise SystemExit(
            f"sweep: {A} traces vs {V} --vary sets — lengths must match, "
            "or one side must be a single entry to replicate"
        )
    return traces, synths, ovs


def _check_pool_flags(ns) -> None:
    """The pool path has its own durability story (per-unit element
    checkpoints + the lease ledger); flags that configure the in-fleet
    one would silently do nothing, so they are refused loudly."""
    from ..cli import _supervised

    if _supervised(ns):
        raise SystemExit(
            "sweep: --checkpoint-*/--resume/--guard configure the "
            "in-process supervised path; with --workers every unit is "
            "checkpointed under --pool-dir automatically"
        )
    for flag, active in (
        ("--report-dir", getattr(ns, "report_dir", None)),
        ("--strict", getattr(ns, "strict", False)),
    ):
        if active:
            raise SystemExit(
                f"sweep: {flag} is not supported with --workers (the "
                "pooled report is --report; bad units quarantine into "
                "their own JSON lines)"
            )
    if ns.fork_prefix != "off":
        raise SystemExit(
            "sweep: --fork-prefix needs the shared in-process fleet; with "
            "--workers use --warm-cache on (workers fork from the "
            "warm-state cache instead)"
        )


def _crash_flag(worker_id: str) -> list[str]:
    spec = os.environ.get("PRIMETPU_POOL_CRASH", "")
    for part in spec.split(","):
        wid, _, chunks = part.partition(":")
        if wid == worker_id and chunks.isdigit():
            return ["--crash-after-chunks", chunks]
    return []


def device_flag(device) -> list[str]:
    """The `--device` argument a spawned child needs to run where its
    parent runs: `--device cpu` on the CPU, nothing (the card) else."""
    return ["--device", "cpu"] if device.type == "cpu" else []


def _spawn_worker(ns, socket_path: str, worker_id: str, device):
    cmd = [
        sys.executable, "-m", "primesim_tpu_torch", "worker",
        "--connect", socket_path,
        "--worker-id", worker_id,
        "--warm-cache", ns.warm_cache,
        "--exec-cache", getattr(ns, "exec_cache", "off"),
        "--overlap", getattr(ns, "overlap", "off"),
        "--reconnect-timeout", str(ns.lease_ttl * 6.0),
        *device_flag(device),
        *_crash_flag(worker_id),
    ]
    # stdout is the campaign's JSON surface — workers must not write to
    # it; their stderr (device lines, tracebacks) passes through
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL)


def run_pooled_sweep(ns, cfg) -> int:
    """The `--workers N` sweep path: coordinator + worker subprocesses.
    Emits the same per-element JSON lines as the in-process sweep, plus
    pool stats in the aggregate line. Exit 0 on a clean campaign, 3 when
    any unit was poisoned or quarantined (partial, like sweep's)."""
    from ..cli import _build_recorder, _finalize_obs
    from ..sim.engine import resolve_device

    _check_pool_flags(ns)
    traces, synths, ovs = _fan_sources(ns)
    device = resolve_device(ns.device)  # no card, no --device cpu: raise
    devices = int(getattr(ns, "devices", 0) or 0)
    if devices:
        # fail the campaign up front (exit 2, typed) rather than letting
        # every worker quarantine its first unit on the same bad mesh
        from ..parallel.sharding import validate_devices

        validate_devices(cfg, devices, "gpu" if device.type == "cuda" else "cpu")
    units = build_units(
        cfg, traces, synths, ovs,
        fold=ns.fold,
        chunk_steps=ns.chunk_steps,
        max_steps=ns.max_steps or 10_000_000,
        warm_cache=ns.warm_cache == "on",
        devices=devices,
    )
    ephemeral = ns.pool_dir is None
    pool_dir = ns.pool_dir or tempfile.mkdtemp(prefix="primetpu-pool-")
    rec = _build_recorder(ns)
    coord = PoolCoordinator(
        units,
        pool_dir,
        lease_ttl_s=ns.lease_ttl,
        poison_threshold=ns.poison_threshold,
        hedge=ns.hedge == "on",
        obs=rec,
        attest=ns.attest,
        audit_rate=ns.audit_rate,
    )
    if coord.recovered["results_adopted"]:
        print(
            f"sweep: pool ledger replayed — "
            f"{coord.recovered['results_adopted']} unit(s) already done, "
            f"{len(units) - coord.recovered['results_adopted']} to go",
            file=sys.stderr,
        )
    coord.start()
    print(
        f"sweep: pool of {ns.workers} worker(s) on {coord.socket_path} "
        f"({len(units)} units, lease ttl {ns.lease_ttl:.1f}s, "
        f"device {device})",
        file=sys.stderr,
    )
    workers = [
        _spawn_worker(ns, coord.socket_path, f"w{k}", device)
        for k in range(ns.workers)
    ]
    respawns = 0
    t0 = time.perf_counter()
    try:
        while not coord.done:
            coord.tick()
            live = [w for w in workers if w.poll() is None]
            if not live:
                # the failure detector found them all dead and will have
                # re-dispatched their units; keep ONE replacement coming
                # so the campaign cannot hang (liveness)
                if respawns >= max(4, 2 * ns.workers):
                    print(
                        "sweep: workers keep dying and the respawn budget "
                        "is spent; abandoning the campaign",
                        file=sys.stderr,
                    )
                    break
                respawns += 1
                wid = f"w{ns.workers + respawns - 1}"
                print(f"sweep: all workers dead; spawning {wid}",
                      file=sys.stderr)
                workers.append(
                    _spawn_worker(ns, coord.socket_path, wid, device))
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        # campaign done: workers see {done: true} on their next lease
        # request and exit 0 on their own
        deadline = time.time() + 10.0
        for w in workers:
            try:
                w.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                w.kill()
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        coord.close(drained=coord.done)

    return _emit_campaign(ns, cfg, coord, wall, rec, _finalize_obs,
                          pool_dir, ephemeral)


def _emit_campaign(ns, cfg, coord, wall, rec, finalize_obs,
                   pool_dir: str, ephemeral: bool) -> int:
    total_ins = 0
    casualties = 0
    results = coord.results()
    for r in results:
        if r["state"] == DONE and r["result"] is not None:
            line = r["result"]
            if line.get("metric") == "simulated_MIPS":
                total_ins += int(line["detail"].get("instructions", 0))
            else:
                casualties += 1  # worker-side quarantine
            print(json.dumps(line))
        elif r["state"] == SUSPECT:
            # distinct from poison: the results diverged under
            # attestation and the tiebreak could not adjudicate — the
            # held evidence stays in the pool ledger
            casualties += 1
            print(json.dumps({
                "metric": "suspect",
                "value": None,
                "unit": None,
                "detail": {
                    "engine": "fleet",
                    "fleet_index": r["index"],
                    "unit_id": r["unit_id"],
                    "status": "suspect",
                    "workers": r["suspects"],
                    "detail": (
                        "attested results diverged and a tiebreak did "
                        "not adjudicate; all held payloads are in the "
                        "pool ledger"
                    ),
                },
            }))
        elif r["state"] == POISON:
            casualties += 1
            print(json.dumps({
                "metric": "poisoned",
                "value": None,
                "unit": None,
                "detail": {
                    "engine": "fleet",
                    "fleet_index": r["index"],
                    "unit_id": r["unit_id"],
                    "status": "poisoned",
                    "kills": r["kills"],
                    "detail": (
                        f"unit killed {len(r['kills'])} distinct "
                        "worker(s); quarantined from the campaign"
                    ),
                },
            }))
        else:  # campaign abandoned with units in flight
            casualties += 1
            print(json.dumps({
                "metric": "unfinished",
                "value": None,
                "unit": None,
                "detail": {
                    "engine": "fleet",
                    "fleet_index": r["index"],
                    "unit_id": r["unit_id"],
                    "status": r["state"].lower(),
                },
            }))
    pool = coord.pool_report()
    print(json.dumps({
        "metric": "fleet_aggregate_MIPS",
        "value": round(total_ins / max(wall, 1e-9) / 1e6, 3),
        "unit": "MIPS",
        "detail": {
            "engine": "fleet",
            "n_elements": len(results),
            "n_cores": cfg.n_cores,
            "instructions": total_ins,
            "wall_s": round(wall, 3),
            "pool": pool,
        },
    }))
    if ns.report:
        import numpy as np

        from ..stats.counters import COUNTER_NAMES
        from ..stats.report import write_report

        # per-core axes span heterogeneous units — they render zero and
        # the POOL section carries the campaign story (the SERVICE
        # report's convention)
        write_report(
            ns.report, cfg,
            {k: np.zeros(cfg.n_cores, np.int64) for k in COUNTER_NAMES},
            np.zeros(cfg.n_cores, np.int64),
            title="primetpu sweep --workers",
            pool=pool,
            timeline=rec.timeline_summary() if rec is not None else None,
        )
        print(f"report written to {ns.report}", file=sys.stderr)
    finalize_obs(rec)
    if casualties:
        print(
            f"sweep: partial — {casualties} of {len(results)} units "
            "poisoned/quarantined/unfinished",
            file=sys.stderr,
        )
        return 3
    if ephemeral:
        shutil.rmtree(pool_dir, ignore_errors=True)
    return 0
