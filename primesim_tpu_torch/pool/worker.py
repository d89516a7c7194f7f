"""Pool worker — one process, one fleet element at a time (DESIGN.md §17):
the JAX package's `pool/worker.py` for the port.

A worker is a pull loop against the coordinator socket: lease a unit,
materialize its workload locally (deterministic, same contract as
`serve.scheduler.materialize_workload`), simulate it under a
`RunSupervisor` whose `on_chunk` callback does the two pool duties —

- element-checkpoint the unit to its deterministic path under the pool
  directory (atomic tmp+rename), so whoever re-leases this unit after we
  die resumes from the last committed chunk instead of step 0;
- heartbeat the lease every ttl/3; a `lost` reply means the coordinator
  expired or superseded us (we were presumed dead, or a hedge twin won)
  and we abandon the unit without acking.

The worker NEVER trusts its connection: every coordinator call rides a
decorrelated-jitter reconnect loop (util.backoff), and a heartbeat that
cannot reach the coordinator is tolerated — we keep simulating, because
first-ACK-wins means a result computed during a network hole still
counts when the link returns. Only when the coordinator stays dark past
`reconnect_timeout_s` does the worker give up (exit 75, EX_TEMPFAIL).

The device: a worker simulates on the card unless it was given
`device="cpu"`. It resolves the device once, at its first unit that
simulates (an ingest unit only reads and writes files and never touches
CUDA), and loads the kernels there, before the unit's clock starts. No
card and no explicit device raises out of `run`, so the process exits
non-zero: a worker never falls back to the CPU. Several workers share
one card, each with its own CUDA context.

Crash injection rides the chaos crashpoint registry (DESIGN.md §20):
the worker's committed-chunk boundary is the `worker.post-checkpoint`
site and the moment before its ack is `worker.pre-ack`. The
`crash_after_chunks=N` knob (and the `PRIMETPU_POOL_CRASH` env alias
the campaign translates into it) installs a one-event FaultPlan killing
this process at the Nth `worker.post-checkpoint` arrival. In-process
tests use `simulate_crash=True`, which swaps the kill for a raised
`SimulatedCrash` at the same site (the test then plays the role of the
dead process by simply not acking).

Not ported: the JAX worker's sharded units (`devices` > 0, its
`_unit_mesh`) are not on the port's tile mesh (`parallel/sharding.py`)
yet; such a unit is quarantined with `MultiDeviceNotPorted`.

At a grant the unit's fleet loads (or builds) its kernels through the
kernel build cache when `--exec-cache on` made one active
(`fleet.warm_exec()`, before the first chunk, so no build eats into the
lease), and runs with overlapped dispatch under `--overlap on`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from ..chaos import plan as cplan
from ..chaos import sites as chaos
from ..serve.protocol import request
from ..util.backoff import DecorrelatedJitter, jittered

EX_TEMPFAIL = 75


class LeaseLost(Exception):
    """Coordinator told us the lease is gone (expired and re-dispatched,
    or the unit already finished) — abandon the unit, take the next."""


class SimulatedCrash(Exception):
    """In-process stand-in for SIGKILL: the test's worker vanishes
    mid-unit without acking or cleaning up."""


class MultiDeviceNotPorted(ValueError):
    """A unit, a serving daemon or a streamed run asked for a machine
    sharded over several devices: the tile mesh drives `run` and `sweep`
    (`parallel/sharding.py`), and these paths run one device until they
    are ported onto it."""

    def __init__(self, devices: int):
        super().__init__(
            f"devices={devices}: sharding a unit, a serving bucket or a "
            "streamed run over several devices is not ported (they run "
            "on one device; run and sweep take --devices)"
        )
        self.devices = int(devices)

    def location(self) -> dict:
        return {"devices": self.devices}


class _Heartbeat:
    """Background lease keep-alive for one unit. Runs on its own daemon
    thread so the lease survives phases where the simulation can't reach
    a chunk boundary — trace materialization and the first chunk of a
    new geometry, which alone can outlast a short TTL. The thread only
    SETS flags; the simulating thread raises LeaseLost at the next chunk
    boundary (a clean commit point)."""

    def __init__(self, worker: "PoolWorker", unit_id: str, epoch: int,
                 interval_s: float):
        self.worker = worker
        self.unit_id = unit_id
        self.epoch = epoch
        self.interval_s = interval_s
        self.lost = False
        self.steps = 0  # updated by the simulating thread
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "_Heartbeat":
        self._t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=2.0)

    def _run(self) -> None:
        down_since = None
        # any failure — refused connect, reset mid-reply, protocol
        # garbage from a half-restarted coordinator — must leave this
        # thread ALIVE and retrying under decorrelated jitter: a dead
        # keep-alive thread under a healthy simulation looks exactly
        # like a worker death and gets the lease expired out from under
        # a run that is still making progress
        jitter = DecorrelatedJitter(
            base=min(0.2, self.interval_s),
            cap=max(self.interval_s, 0.2),
            rng=self.worker.rng,
        )
        wait_s = self.interval_s
        while not self._stop.wait(wait_s):
            try:
                reply = self.worker._call({
                    "verb": "heartbeat",
                    "unit_id": self.unit_id,
                    "epoch": self.epoch,
                    "steps": int(self.steps),
                }, patient=False)
            except Exception:  # noqa: BLE001 — reconnect, never die
                # keep simulating through the hole: first-ACK-wins makes
                # the result still worth computing, unless the
                # coordinator stays dark past the reconnect window
                now = time.monotonic()
                if down_since is None:
                    down_since = now
                elif now - down_since >= self.worker.reconnect_timeout_s:
                    self.lost = True
                    return
                wait_s = jitter.next_delay()
                continue
            down_since = None
            jitter.reset()
            wait_s = self.interval_s
            if reply.get("lost"):
                self.lost = True
                return


class PoolWorker:
    def __init__(
        self,
        socket_path: str,
        worker_id: str,
        warm_cache: bool = False,
        reconnect_timeout_s: float = 60.0,
        crash_after_chunks: int | None = None,
        simulate_crash: bool = False,
        rng=None,
        idle_exit_s: float | None = None,
        device=None,
        overlap: bool = False,
    ):
        self.socket_path = str(socket_path)
        self.overlap = bool(overlap)
        self.worker_id = str(worker_id)
        self.warm_cache = bool(warm_cache)
        self.reconnect_timeout_s = float(reconnect_timeout_s)
        self.simulate_crash = bool(simulate_crash)
        if crash_after_chunks is not None:
            # one-event crashpoint plan. Installing per construction
            # resets the occurrence counter, so the count is this
            # worker's own committed chunks.
            chaos.install(
                cplan.FaultPlan(seed=0, events=(cplan.FaultEvent(
                    site="worker.post-checkpoint",
                    occurrence=int(crash_after_chunks),
                    action="kill",
                ),)),
                mode="raise" if self.simulate_crash else "kill",
                crash_exc=SimulatedCrash if self.simulate_crash else None,
            )
        self.rng = rng
        self.idle_exit_s = idle_exit_s
        # the device asked for (None: the card) and the one resolved at
        # the first simulated unit
        self.device_arg = device
        self.device = None
        self.kernel_load_s = None  # seconds to load the kernels, on a card
        self.units_done = 0
        self.units_lost = 0
        self._toolchain_cache = None
        # per-unit seconds: element checkpoints written, and unit walls
        self.checkpoint_s = 0.0
        self.unit_walls: dict[str, float] = {}
        # warm slot fleets, one per geometry bucket: keyed by (config
        # JSON, events capacity, chunk_steps), so serve jobs in the same
        # bucket reuse the fleet (and its device buffers) across units —
        # the per-worker half of the front-end's slot-bucket design
        self._bucket_fleets: dict[tuple, object] = {}

    def _toolchain(self) -> dict:
        """The toolchain fields the coordinator verifies on attested lease
        grants (chain heads from different toolchains would diverge for
        boring reasons). Sent on every lease; ignored by attest-off
        coordinators."""
        if self._toolchain_cache is None:
            from ..attest import toolchain_fingerprint

            self._toolchain_cache = toolchain_fingerprint()
        return self._toolchain_cache

    def _ensure_device(self):
        """Resolve the device once (the card unless `device="cpu"` was
        given; no card raises) and load the kernels on a card, before a
        unit's clock starts. Prints the worker's device on stderr."""
        if self.device is not None:
            return self.device
        import torch

        from ..kernels import build
        from ..sim.engine import resolve_device

        dev = resolve_device(self.device_arg)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            build.libraries(build.KERNELS)
            name = torch.cuda.get_device_name(dev)
        else:
            name = "cpu"
        self.kernel_load_s = time.perf_counter() - t0
        self.device = dev
        _stderr_line(f"worker {self.worker_id}: device {dev} ({name}), "
                     f"kernels loaded in {self.kernel_load_s:.3f} s")
        return dev

    # ---- coordinator RPC with reconnect ----------------------------------

    def _call(self, req: dict, patient: bool = True) -> dict:
        """One verb round-trip. With `patient`, connection failures retry
        under decorrelated jitter until `reconnect_timeout_s` of
        continuous darkness, then re-raise (the campaign is gone)."""
        req = {**req, "worker": self.worker_id}
        jitter = DecorrelatedJitter(base=0.2, cap=5.0, rng=self.rng)
        deadline = time.monotonic() + self.reconnect_timeout_s
        while True:
            try:
                return request(self.socket_path, req)
            except (ConnectionError, OSError):
                if not patient or time.monotonic() >= deadline:
                    raise
                time.sleep(jitter.next_delay())

    # ---- the pull loop ---------------------------------------------------

    def run(self) -> int:
        """Lease/execute until the coordinator says the campaign is done
        (exit 0) or stays unreachable (exit 75). With `idle_exit_s`, a
        worker left idle that long also exits 0 — the autoscaling
        front-end's scale-DOWN path (it respawns workers on demand)."""
        idle_since = None
        while True:
            try:
                reply = self._call({"verb": "lease",
                                    "toolchain": self._toolchain()})
            except (ConnectionError, OSError):
                return EX_TEMPFAIL
            if reply.get("refused"):
                # attested admission said no — quarantined as SUSPECT or
                # wrong toolchain. Terminal for this worker: retrying
                # with the same identity/toolchain can never succeed.
                print(json.dumps({"worker": self.worker_id,
                                  "refused": reply["refused"],
                                  "error": reply.get("error")}),
                      file=sys.stderr, flush=True)
                return EX_TEMPFAIL
            if not reply.get("ok", False):
                time.sleep(jittered(1.0, rng=self.rng))
                continue
            if reply.get("done"):
                return 0
            if reply.get("idle"):
                now = time.monotonic()
                if idle_since is None:
                    idle_since = now
                elif (self.idle_exit_s is not None
                      and now - idle_since >= self.idle_exit_s):
                    return 0
                time.sleep(
                    jittered(float(reply.get("retry_after_s", 1.0)),
                             rng=self.rng)
                )
                continue
            idle_since = None
            self.run_unit(reply)

    # ---- unit execution --------------------------------------------------

    def run_unit(self, grant: dict) -> None:
        """Simulate one leased unit and ack its result. Lease loss
        abandons silently; workload errors ack a quarantined result so
        the campaign records the casualty and moves on. A device that
        cannot be had is not a workload error: it raises."""
        unit = grant["unit"]
        epoch = int(grant["epoch"])
        if unit.get("kind") != "ingest" and not unit.get("devices"):
            self._ensure_device()
        t0 = time.perf_counter()
        try:
            result, resumed_steps = self._simulate(grant)
        except LeaseLost:
            self.units_lost += 1
            return
        except SimulatedCrash:
            raise
        except Exception as e:  # noqa: BLE001 — a bad unit must not kill us
            result = _quarantine_result(unit, e)
            resumed_steps = 0
        self.unit_walls[unit["unit_id"]] = time.perf_counter() - t0
        # the unit is fully simulated and checkpointed but NOT acked —
        # dying here is the classic lost-result window the coordinator's
        # lease expiry + re-dispatch must absorb
        chaos.crashpoint("worker.pre-ack")
        ack = {
            "verb": "ack",
            "unit_id": unit["unit_id"],
            "epoch": epoch,
            "key": unit["key"],
            "result": result,
            "resumed_steps": resumed_steps,
        }
        attest = (result or {}).get("detail", {}).get("attest")
        if attest:
            ack["attest"] = attest
        if grant.get("audit"):
            ack["audit"] = True
        try:
            self._call(ack)
            self.units_done += 1
        except (ConnectionError, OSError):
            # result lost with the coordinator; the unit's checkpoint
            # survives, so the re-lease (to us or a peer) is cheap
            self.units_lost += 1

    def _simulate(self, grant: dict) -> tuple[dict, int]:
        unit = grant["unit"]
        unit_id = unit["unit_id"]
        epoch = int(grant["epoch"])
        ttl = float(grant.get("lease_ttl_s", 10.0))
        ckpt_path = os.path.join(
            grant["pool_dir"], "units", f"{unit_id}.npz"
        )
        # keep-alive from the moment of the grant: materialization and the
        # first chunk happen before the first chunk boundary and must not
        # look like a death to the coordinator
        hb = _Heartbeat(
            self, unit_id, epoch,
            # clock-skew site: a skewed interval makes the worker
            # heartbeat too slowly and drift into lease expiry
            interval_s=chaos.clock_skew(
                "worker.heartbeat.interval", max(0.1, ttl / 3.0)
            ),
        ).start()
        try:
            return self._simulate_leased(grant, unit, unit_id, ckpt_path,
                                         hb)
        finally:
            hb.stop()

    def _bucket_fleet(self, unit, cfg):
        """The warm slot fleet for a unit's geometry bucket
        (`capacity_pages` units = serve jobs dispatched by the elastic
        front-end). Built once per (config, capacity, chunk_steps) and
        reused across every unit in the bucket — `replace_element`
        splices workloads in place."""
        from ..serve.scheduler import PAGE_EVENTS
        from ..sim.fleet import FleetEngine

        cap = int(unit["capacity_pages"]) * PAGE_EVENTS
        key = (unit["config"], cap, int(unit["chunk_steps"]))
        fleet = self._bucket_fleets.get(key)
        if fleet is None:
            fleet = FleetEngine.make_slots(
                cfg, 1, cap, chunk_steps=int(unit["chunk_steps"]),
                device=self.device,
            )
            self._bucket_fleets[key] = fleet
        return fleet

    def _simulate_leased(self, grant, unit, unit_id, ckpt_path,
                         hb) -> tuple[dict, int]:
        from ..config.machine import MachineConfig
        from ..serve.scheduler import parse_synth_spec
        from ..sim.checkpoint import load_element_checkpoint
        from ..sim.fleet import FleetEngine
        from ..sim.supervisor import RunSupervisor
        from ..trace.format import Trace, fold_ins

        cfg = MachineConfig.from_json(unit["config"])
        if unit.get("kind") == "ingest":
            # MPMD pipeline stage 1 (DESIGN.md §22): materialize one trace
            # segment to the pool dir instead of simulating anything
            return self._ingest_segment(grant, unit, cfg, hb)
        if unit.get("devices"):
            raise MultiDeviceNotPorted(int(unit["devices"]))
        if unit["synth"] is not None:
            trace = parse_synth_spec(unit["synth"], cfg.n_cores,
                                     unit["fold"])
        else:
            trace = Trace.load(unit["trace_path"])
            if unit["fold"]:
                trace = fold_ins(trace)
        bucketed = unit.get("capacity_pages") is not None
        if bucketed:
            fleet = self._bucket_fleet(unit, cfg)
            fleet.replace_element(0, trace, override=dict(unit["overrides"]))
        else:
            fleet = FleetEngine(
                cfg, [trace], [dict(unit["overrides"])],
                chunk_steps=int(unit["chunk_steps"]),
                device=self.device,
            )
        fleet.overlap = self.overlap
        # the kernels from the build cache now, under the grant's
        # heartbeat, so no build eats into the lease (a no-op without one)
        fleet.warm_exec()

        attest_on = grant.get("attest") == "chain"
        # tiebreak / audit re-runs are granted `fresh`: no checkpoint
        # resume, no warm fork, no checkpoint WRITES — their chains must
        # cover the whole run, and the unit checkpoint on disk belongs
        # to the execution under adjudication
        fresh = bool(grant.get("fresh"))
        fleet.attest = None  # bucketed fleets are reused across units
        resumed_steps = 0
        ckpt_attest = None
        if grant.get("checkpoint") and not fresh:
            try:
                snap = load_element_checkpoint(
                    ckpt_path, fleet.elem_cfgs[0], trace, device=self.device
                )
                fleet.restore_element(0, snap)
                resumed_steps = int(fleet.steps_run[0])
                ckpt_attest = snap.get("attest")
            except Exception:
                # corrupt / mismatched / AttestationError (payload sha
                # refuted the checkpoint, §24): fresh start — slower but
                # honest, and the fresh chain covers every chunk we ack
                resumed_steps = 0
                ckpt_attest = None
        if (resumed_steps == 0 and not fresh
                and unit.get("warm_cache") and self.warm_cache):
            resumed_steps = self._warm_fork(fleet, trace)
        if attest_on:
            from ..attest import FleetAttest

            fa = FleetAttest()
            cs = int(unit["chunk_steps"])
            if (ckpt_attest and ckpt_attest.get("head")
                    and int(ckpt_attest.get("chunk_steps", 0)) == cs):
                fa.track(0, cs, start=int(ckpt_attest.get("start", 0)),
                         head=ckpt_attest["head"],
                         chunks=int(ckpt_attest.get("chunks", 0)))
            else:
                # fresh run, warm fork, or pre-attestation checkpoint:
                # the chain's coverage starts where this execution does
                fa.track(0, cs, start=resumed_steps)
            fleet.attest = fa

        def on_chunk(sup):
            # checkpoint BEFORE the crashpoint: a worker killed at chunk
            # N leaves chunk N durable, so the re-lease resumes exactly
            # where the victim died
            if not fresh:
                self._checkpoint(ckpt_path, fleet, unit_id)
            chaos.crashpoint("worker.post-checkpoint")
            hb.steps = int(fleet.steps_run[0])
            if hb.lost:
                # expired-and-superseded, or the coordinator stayed dark
                # past the reconnect window: abandon at this clean commit
                # point (the checkpoint above stays for whoever re-leases)
                raise LeaseLost(unit_id)

        sup = RunSupervisor(fleet, handle_signals=False, on_chunk=on_chunk)
        t0 = time.perf_counter()
        try:
            sup.run(max_steps=int(unit["max_steps"]))
        except BaseException:
            fleet.attest = None
            if bucketed:
                # evict the failed workload so the warm fleet is clean
                # for the next unit in this bucket
                try:
                    fleet.clear_element(0)
                except Exception:
                    self._bucket_fleets.pop(
                        (unit["config"], fleet.events_capacity,
                         int(unit["chunk_steps"])), None)
            raise
        wall = time.perf_counter() - t0

        # the per-element record, field for field the shape the JAX
        # worker acks (and `sweep` emits in-process)
        ec = fleet.element_counters(0)
        ins = int(ec["instructions"].sum())
        result = {
            "metric": "simulated_MIPS",
            "value": round(ins / max(wall, 1e-9) / 1e6, 3),
            "unit": "MIPS",
            "detail": {
                "engine": "fleet",
                "fleet_index": unit["index"],
                "n_cores": cfg.n_cores,
                "instructions": ins,
                "max_core_cycles": int(fleet.cycles[0].max()),
                "overrides": dict(unit["overrides"]),
                "wall_s": round(wall, 3),
                "noc_msgs": int(ec["noc_msgs"].sum()),
            },
        }
        if unit.get("serve_job"):
            # the front-end maps this into the serve job's result —
            # present ONLY for serve units so sweep records stay the
            # JAX package's shape
            result["detail"]["core_cycles"] = [
                int(c) for c in fleet.cycles[0]
            ]
            result["detail"]["steps"] = int(fleet.steps_run[0])
            result["detail"]["counters"] = {
                k: [int(x) for x in v] for k, v in ec.items()
            }
        if attest_on and fleet.attest is not None:
            # present ONLY under --attest chain, so attest-off records
            # stay byte-identical
            result["detail"]["attest"] = fleet.attest.payload(0)
            fleet.attest = None
        if bucketed:
            fleet.clear_element(0)
        return result, resumed_steps

    def _ingest_segment(self, grant, unit, cfg, hb) -> tuple[dict, int]:
        """Execute one MPMD ingest unit: materialize trace segment
        `seg_index` (line-normalized, END-padded) and write it atomically
        under the pool dir for the sim stage to consume. Deterministic,
        so hedged twins and re-leases produce identical bytes. Host work
        only: no device is resolved for it."""
        from ..ingest.pipeline import (
            normalize_segment,
            segment_path,
            write_segment,
        )
        from ..serve.scheduler import parse_synth_spec
        from ..trace.format import Trace

        if unit["synth"] is not None:
            trace = parse_synth_spec(unit["synth"], cfg.n_cores,
                                     unit["fold"])
        else:
            trace = Trace.load(unit["trace_path"], mmap=True)
        k = int(unit["seg_index"])
        L = int(unit["seg_events"])
        t0 = time.perf_counter()
        arr, n_valid = normalize_segment(cfg, trace, k, L)
        path = segment_path(grant["pool_dir"], k)
        write_segment(path, k, L, arr)
        if hb.lost:
            raise LeaseLost(unit["unit_id"])
        return {
            "metric": "ingested_events",
            "value": n_valid,
            "unit": "events",
            "detail": {
                "engine": "ingest",
                "fleet_index": unit["index"],
                "seg_index": k,
                "seg_events": L,
                "n_cores": cfg.n_cores,
                "path": path,
                "wall_s": round(time.perf_counter() - t0, 3),
            },
        }, 0

    def _checkpoint(self, path: str, fleet, unit_id: str) -> None:
        from ..sim.checkpoint import save_element_checkpoint

        t0 = time.perf_counter()
        save_element_checkpoint(path, fleet, 0, job_id=unit_id)
        self.checkpoint_s += time.perf_counter() - t0

    def _warm_fork(self, fleet, trace) -> int:
        """Warm-state cache consult (DESIGN.md §16) for a fresh unit:
        fork from the deepest proven prefix of this exact workload."""
        from ..sim.checkpoint import (
            CheckpointCorrupt,
            find_warm_states,
            load_warm_state,
            trace_fingerprint,
            warm_cache_root,
        )

        root = warm_cache_root()
        ecfg = fleet.elem_cfgs[0]
        fp = trace_fingerprint(trace)
        for steps, key in find_warm_states(root, ecfg, fp):
            try:
                snap = load_warm_state(root, key, ecfg, fp, steps,
                                       device=self.device)
            except (FileNotFoundError, CheckpointCorrupt, ValueError):
                continue
            fleet.fork_element(0, snap, cache_key=key)
            return steps
        return 0


def _stderr_line(text: str) -> None:
    """One whole line in one write: the workers of a pool share their
    parent's stderr, and a line split over two writes can interleave
    with another worker's."""
    sys.stderr.write(text + "\n")
    sys.stderr.flush()


def _quarantine_result(unit: dict, exc: BaseException) -> dict:
    from ..serve.protocol import error_obj

    return {
        "metric": "quarantined",
        "value": None,
        "unit": None,
        "detail": {
            "engine": "fleet",
            "fleet_index": unit["index"],
            "status": "quarantined",
            "overrides": dict(unit["overrides"]),
            **error_obj(exc),
        },
    }


def run_worker(
    socket_path: str,
    worker_id: str,
    warm_cache: bool = False,
    reconnect_timeout_s: float = 60.0,
    crash_after_chunks: int | None = None,
    idle_exit_s: float | None = None,
    device=None,
    overlap: bool = False,
) -> int:
    """The `worker` verb: one stderr line when the worker starts (its id
    and the device it was asked for), one when it resolves the device
    (the card's name), and one when it exits, SIGTERM included (units,
    checkpoint seconds, unit walls and `build.LAUNCHES`). Stdout stays
    the campaign's."""
    import signal

    from ..kernels import build

    def _term(signum, frame):
        # a scale-down or a drain (SIGTERM): leave through the exit line
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread: an in-process caller
        pass
    _stderr_line(f"worker {worker_id}: pid {os.getpid()}, device "
                 f"{device or 'cuda'} asked for, coordinator {socket_path}")
    w = PoolWorker(
        socket_path,
        worker_id,
        warm_cache=warm_cache,
        reconnect_timeout_s=reconnect_timeout_s,
        crash_after_chunks=crash_after_chunks,
        idle_exit_s=idle_exit_s,
        device=device,
        overlap=overlap,
    )
    rc = "raised"  # the device could not be had, or a signal
    try:
        rc = w.run()
    except SystemExit as e:
        rc = e.code
        raise
    finally:
        _stderr_line(f"worker {worker_id}: exit {rc}, " + json.dumps({
            "units_done": w.units_done, "units_lost": w.units_lost,
            "checkpoint_s": round(w.checkpoint_s, 3),
            "unit_walls_s": {k: round(v, 3) for k, v in w.unit_walls.items()},
            "kernel_load_s": w.kernel_load_s, "launches": dict(build.LAUNCHES),
        }))
    return rc
