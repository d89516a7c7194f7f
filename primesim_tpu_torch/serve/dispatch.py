"""Dispatch scheduler — the elastic front-end's remote execution path
(DESIGN.md §18): the JAX package's `serve/dispatch.py` for the port.

`PrimeServer(pool_dir=...)` (`serve --pool-dir`) swaps the in-process `Scheduler` for this
class: same journal, same job table, same verb surface, but instead of
splicing jobs into local fleet slots it converts each accepted job into
a pool WORK UNIT (units.py) and enqueues it on a dynamic-mode
coordinator, where an autoscaling fleet of `python -m primesim_tpu_torch
worker` processes executes it under the lease/heartbeat/ack protocol.
Each worker owns a warm fleet per geometry bucket, so the slot-bucket
design scales from one process's batch axis to a process fleet. The
front-end simulates nothing: its children run where it was told to run
(`--device cpu` is passed on to them; the card otherwise), several
workers sharing one card.

Process model (everything crash-only):

- the COORDINATOR is spawned as a subprocess over `--pool-dir` unless
  something already listens on the pool socket — in which case this
  front-end ADOPTS it (the standby-takeover path: kill -9 the primary
  front-end, start another on the same state dir + pool dir, and the
  coordinator, its workers, and every lease keep running);
- WORKERS autoscale: the front-end keeps min(max_workers, nonterminal
  jobs) alive, spawning with `--idle-exit` so drained capacity retires
  itself; worker death needs no bookkeeping here because lease expiry
  already re-dispatches (the pool's failure detector is the only one);
- the front-end's own kill -9 is covered by the serve journal: replay
  rebuilds the job table and `requeue_recovered` re-enqueues — the
  coordinator's idempotent `enqueue` verb replies with the unit's
  CURRENT state, including results computed while the front-end was
  dead, so nothing re-simulates.

Bit-exactness: workers run serve units in capacity buckets from the
same page ladder with the same chunking, and their extended ack detail
is mapped 1:1 onto the shape `Scheduler._element_result` produces — a
job's result is identical whether it ran locally, remotely, or via a
post-crash re-dispatch.

Sharded geometry buckets: with `devices` > 0 every unit asks its
worker for a tile mesh of that many devices (`parallel/sharding.py`).
When a worker cannot host it (devices revoked, too few visible) the unit
comes back quarantined with a `DeviceMeshError`; the dispatcher then
shrinks its bucket to the largest mesh the reported capacity can host
and re-enqueues the job under a fresh unit id (`_rebucket_devices`),
journaled with a `rebucket` detail and a serve event.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from ..obs.metrics import Histogram
from ..pool.campaign import device_flag
from ..pool.units import unit_key
from . import jobs as J
from .protocol import error_obj, request, socket_alive
from .scheduler import (
    DEFAULT_BUCKETS,
    PAGE_EVENTS,
    QueueFull,
    materialize_workload,
)


class DispatchScheduler:
    """Scheduler-API-compatible front half over a worker pool. The
    server's tick loop, verb handlers, and recovery path drive it
    exactly like the local Scheduler."""

    def __init__(
        self,
        cfg,
        journal,
        state_dir: str,
        pool_dir: str,
        buckets=DEFAULT_BUCKETS,
        chunk_steps: int = 128,
        max_queue: int = 64,
        max_workers: int = 2,
        lease_ttl_s: float = 10.0,
        obs=None,
        spawn: bool = True,
        poll_every_s: float = 0.2,
        devices: int = 0,
        attest: str = "off",
        audit_rate: float = 0.0,
        device=None,
    ):
        self.cfg = cfg
        self.journal = journal
        self.obs = obs
        self.attest = str(attest or "off")
        self.audit_rate = float(audit_rate or 0.0)
        self.state_dir = str(state_dir)
        self.pool_dir = str(pool_dir)
        os.makedirs(self.pool_dir, exist_ok=True)
        self.pool_socket = os.path.join(self.pool_dir, "pool.sock")
        self.page_ladder = sorted({int(p) for _, p in buckets})
        self.chunk_steps = int(chunk_steps)
        self.max_queue = int(max_queue)
        self.max_workers = int(max_workers)
        self.lease_ttl_s = float(lease_ttl_s)
        self.spawn = bool(spawn)  # False: tests run coord/workers themselves
        self.poll_every_s = float(poll_every_s)
        # where the children run: `--device cpu` passed on, else the card
        from ..sim.engine import resolve_device

        self.device = resolve_device(device)
        self.devices = int(devices)
        if self.devices:
            # fail service bring-up on a bad mesh shape, not every
            # leased unit on every worker
            from ..parallel.sharding import validate_devices

            validate_devices(cfg, self.devices,
                             "gpu" if self.device.type == "cuda" else "cpu")

        self.jobs: dict[str, J.Job] = {}
        self.queue: list[str] = []  # accepted, not yet enqueued remotely
        self.dispatched: set[str] = set()  # unit ids enqueued, not terminal
        self.unit_aliases: dict[str, str] = {}  # rebucketed unit id -> job id
        self._rebucket_gen = 0
        self.buckets = []  # API parity: no local fleets in dispatch mode
        self._seq = 0
        self._last_poll_t = 0.0
        self._coord_proc = None
        self._coord_spawn_t = 0.0
        self._workers: list = []
        self._worker_seq = 0
        self._last_worker_spawn_t = 0.0
        self.coordinator_adopted = False  # standby takeover happened
        self.started_t = time.time()
        self.total_instructions = 0
        self.completed = 0
        self._latencies: list[float] = []
        self.latency_hist = Histogram()
        self.last_dispatch_t: float | None = None

    def _serve_event(self, kind: str, **args) -> None:
        if self.obs is not None:
            self.obs.serve_event(kind, args)

    # ---- identity ---------------------------------------------------------

    def next_job_id(self) -> str:
        self._seq += 1
        return f"j{self._seq:06d}"

    # ---- admission --------------------------------------------------------

    def submit(self, job: J.Job) -> J.Job:
        """Admit one job: backpressure check, durable accept record
        (fsynced BEFORE this returns — the ACK invariant), workload
        validation + bucket assignment, enqueue for dispatch."""
        if len(self.queue) >= self.max_queue:
            raise QueueFull(
                len(self.queue), retry_after_s=1.0 + 0.1 * len(self.queue)
            )
        self.jobs[job.job_id] = job
        self.journal.accept(job)
        self._serve_event("admit", job_id=job.job_id, client=job.client,
                          priority=job.priority)
        if self._validate_and_bucket(job):
            self.queue.append(job.job_id)
        return job

    def _validate_and_bucket(self, job: J.Job) -> bool:
        """Materialize the workload (deterministic, same as the local
        path), pick the smallest ladder page size whose capacity fits
        the trace, and stash it as `job._pages`. The trace itself is
        dropped — workers re-materialize from the spec; the front-end
        never holds event arrays."""
        try:
            tr = materialize_workload(job, self.cfg)
        except Exception as e:  # bad workload must not kill the daemon
            self._terminal(job, J.QUARANTINED, detail=error_obj(e)["error"])
            return False
        pages = next(
            (p for p in self.page_ladder
             if p * PAGE_EVENTS >= tr.max_len), None
        )
        if pages is None:
            cap = max(self.page_ladder) * PAGE_EVENTS
            self._terminal(
                job, J.QUARANTINED,
                detail={
                    "type": "CapacityError",
                    "location": {},
                    "detail": (
                        f"trace needs {tr.max_len} event slots/core; "
                        f"largest bucket holds {cap}"
                    ),
                },
            )
            return False
        job._pages = pages
        job._trace = None  # workers re-materialize; don't hold events
        job._ctx = None
        return True

    def _unit_spec(self, job: J.Job) -> dict:
        jid = job.job_id
        spec = {
            # a rebucketed job re-enqueues under a FRESH unit id: the
            # coordinator's enqueue is idempotent per (id, key) and the
            # key covers `devices`, so the shrunken bucket is a new unit
            "unit_id": getattr(job, "_unit_alias", None) or jid,
            "index": int(jid[1:]) if jid[1:].isdigit() else 0,
            "config": self.cfg.to_json(),
            "trace_path": job.trace_path,
            "synth": job.synth,
            "fold": bool(job.fold),
            "overrides": dict(job.overrides),
            "chunk_steps": self.chunk_steps,
            "max_steps": int(job.max_steps),
            "warm_cache": False,
            "capacity_pages": int(getattr(job, "_pages", None)
                                  or max(self.page_ladder)),
            "serve_job": True,
            "priority": int(job.priority),
            "client": str(job.client),
        }
        if self.devices:
            # geometry bucket with a mesh shape: the leasing worker owns
            # a fleet sharded over this many devices (shard x vmap)
            spec["devices"] = self.devices
        spec["key"] = unit_key(spec)
        return spec

    # ---- recovery (journal replay, same hooks as Scheduler) ---------------

    def adopt_terminal(self, job: J.Job) -> None:
        self.jobs[job.job_id] = job

    def requeue_recovered(self, job: J.Job) -> None:
        """Journal-replayed non-terminal job after a front-end restart:
        re-validate and line it back up. The coordinator's idempotent
        enqueue resolves what actually happened while we were dead — a
        unit that finished meanwhile comes straight back DONE."""
        self.jobs[job.job_id] = job
        if self._validate_and_bucket(job):
            self.queue.append(job.job_id)

    def cancel(self, job_id: str) -> J.Job:
        job = self.jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        if job.terminal:
            raise ValueError(f"{job_id} already terminal ({job.state})")
        if job_id in self.queue:
            self.queue.remove(job_id)
        # an already-dispatched unit may still finish on a worker; its
        # late collect result is discarded because terminal is sticky
        self.dispatched.discard(job_id)
        alias = getattr(job, "_unit_alias", None)
        if alias:
            self.dispatched.discard(alias)
        self._terminal(job, J.CANCELLED, detail={"detail": "client cancel"})
        return job

    # ---- the dispatch tick ------------------------------------------------

    def tick(self) -> bool:
        """One front-end round: babysit the coordinator, flush pending
        enqueues, autoscale workers, poll for lease/finish transitions.
        Returns True when any job state moved (the server idles its loop
        when False)."""
        now = time.time()
        self._expire_deadlines(now)
        moved = False
        if not self._ensure_coordinator(now):
            return False  # coordinator (re)starting; try next tick
        moved |= self._flush_enqueues()
        self._autoscale(now)
        if now - self._last_poll_t >= self.poll_every_s:
            self._last_poll_t = now
            moved |= self._poll_outcomes()
        return moved

    def _coord_request(self, req: dict) -> dict | None:
        try:
            reply = request(self.pool_socket, req, timeout_s=5.0,
                            connect_timeout_s=2.0)
        except (ConnectionError, OSError):
            return None
        return reply if reply.get("ok") else None

    def _ensure_coordinator(self, now: float) -> bool:
        """True when a coordinator accepts connections on the pool
        socket. An already-live one is ADOPTED (standby takeover, or a
        coordinator that outlived a front-end kill -9 — its leases and
        workers keep running); otherwise spawn one, rate-limited so a
        crash-looping coordinator cannot fork-bomb the host."""
        if socket_alive(self.pool_socket):
            if self._coord_proc is None and not self.coordinator_adopted:
                self.coordinator_adopted = True
                self._serve_event("adopt_coordinator", pool=self.pool_dir)
                self.journal.note(
                    f"dispatch: adopted live coordinator on "
                    f"{self.pool_socket}"
                )
            return True
        if not self.spawn:
            return False
        proc = self._coord_proc
        if proc is not None and proc.poll() is None:
            if now - self._coord_spawn_t < 10.0:
                return False  # own coordinator still binding
            proc.kill()  # alive but never bound: replace, don't stack
            proc.wait(timeout=5)
        if now - self._coord_spawn_t < 1.0:
            return False  # spawn in flight or backing off
        self._coord_spawn_t = now
        self.coordinator_adopted = False
        argv = [
            sys.executable, "-m", "primesim_tpu_torch", "coordinator",
            "--pool-dir", self.pool_dir,
            "--socket", self.pool_socket,
            "--lease-ttl", str(self.lease_ttl_s),
        ]
        if self.attest != "off":
            argv += ["--attest", self.attest,
                     "--audit-rate", str(self.audit_rate)]
        self._coord_proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL)
        self._serve_event("spawn_coordinator", pool=self.pool_dir,
                          pid=self._coord_proc.pid)
        return False  # let it bind; enqueue on a later tick

    def _flush_enqueues(self) -> bool:
        moved = False
        for job_id in list(self.queue):
            job = self.jobs[job_id]
            spec = self._unit_spec(job)
            reply = self._coord_request({"verb": "enqueue", "unit": spec})
            if reply is None:
                break  # coordinator unreachable; retry next tick
            self.queue.remove(job_id)
            self.dispatched.add(spec["unit_id"])
            moved = True
            if reply.get("state") in ("DONE", "POISON", "SUSPECT"):
                # finished while we were down (front-end restart path)
                self._finish_remote(job, reply)
        return moved

    def _autoscale(self, now: float) -> None:
        """Keep min(max_workers, live demand) workers alive. Scale-up is
        spawn; scale-down is the workers' own --idle-exit. Lease expiry
        covers crashed workers' WORK; this covers their CAPACITY."""
        if not self.spawn:
            return
        self._workers = [w for w in self._workers if w.poll() is None]
        want = min(self.max_workers, len(self.queue) + len(self.dispatched))
        if len(self._workers) >= want:
            return
        if now - self._last_worker_spawn_t < 0.5:
            return  # rate-limit a crash-looping fleet
        self._last_worker_spawn_t = now
        while len(self._workers) < want:
            self._worker_seq += 1
            wid = f"dw{self._worker_seq}"
            argv = [
                sys.executable, "-m", "primesim_tpu_torch", "worker",
                "--connect", self.pool_socket,
                "--worker-id", wid,
                "--reconnect-timeout", str(self.lease_ttl_s * 6.0),
                "--idle-exit", "10",
                *device_flag(self.device),
            ]
            # `serve --exec-cache on` passes on: the autoscaled workers
            # load their kernels from the build cache at the lease grant
            from ..sim import exec_cache

            if exec_cache.active() is not None:
                argv += ["--exec-cache", "on"]
            proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL)
            self._workers.append(proc)
            self._serve_event("spawn_worker", worker=wid, pid=proc.pid)

    def _poll_outcomes(self) -> bool:
        if not self.dispatched:
            return False
        reply = self._coord_request(
            {"verb": "collect", "unit_ids": sorted(self.dispatched)}
        )
        if reply is None:
            return False
        moved = False
        for unit_id in reply.get("leased", ()):
            job = self._job_for_unit(unit_id)
            if job is not None and job.state == J.PENDING:
                job.attempts += 1
                job.transition(J.RUNNING)
                self.last_dispatch_t = time.time()
                self.journal.state(
                    job.job_id, J.RUNNING,
                    detail={"attempt": job.attempts, "remote": True},
                )
                self._serve_event("dispatch", job_id=job.job_id,
                                  remote=True, attempt=job.attempts)
                moved = True
        for fin in reply.get("finished", ()):
            job = self._job_for_unit(str(fin.get("unit_id")))
            if job is None or job.terminal:
                continue  # cancelled meanwhile, or unknown: drop
            self._finish_remote(job, fin)
            moved = True
        return moved

    def _job_for_unit(self, unit_id: str) -> J.Job | None:
        """Pool unit id -> serve job: identity for first-dispatch units,
        via the alias map for rebucketed re-enqueues."""
        job = self.jobs.get(unit_id)
        if job is not None:
            return job
        return self.jobs.get(self.unit_aliases.get(unit_id, ""))

    def _finish_remote(self, job: J.Job, fin: dict) -> None:
        """Map a worker's unit outcome onto the serve job, producing the
        same result shape as `Scheduler._element_result`."""
        self.dispatched.discard(job.job_id)
        alias = getattr(job, "_unit_alias", None)
        if alias:
            self.dispatched.discard(alias)
        if job.state == J.PENDING:
            # terminal transitions are only legal from RUNNING; the
            # lease happened while we weren't looking
            job.attempts += 1
            job.transition(J.RUNNING)
            self.last_dispatch_t = time.time()
        rec = fin.get("result") or {}
        detail = rec.get("detail") or {}
        if fin.get("state") == "SUSPECT":
            # attested results diverged and the tiebreak could not
            # adjudicate — terminal like poison, but the held evidence
            # stays in the pool ledger for an offline audit
            suspects = fin.get("suspects") or []
            self._serve_event("suspect", job_id=job.job_id,
                              workers=suspects)
            self._terminal(
                job, J.QUARANTINED,
                detail={
                    "type": "AttestationError",
                    "location": {"unit": job.job_id},
                    "detail": (
                        "attested results diverged across "
                        f"{len(suspects)} worker(s) and a tiebreak did "
                        "not adjudicate; held payloads are in the pool "
                        "ledger"
                    ),
                    "workers": suspects,
                },
            )
            return
        if fin.get("state") == "POISON":
            self._terminal(
                job, J.QUARANTINED,
                detail={
                    "type": "PoisonError",
                    "location": {},
                    "detail": (
                        "unit killed "
                        f"{len(fin.get('kills') or [])} worker(s); "
                        "quarantined as poison"
                    ),
                },
            )
            return
        if rec.get("metric") == "quarantined":
            err = detail.get("error") or {}
            if (err.get("type") == "DeviceMeshError"
                    and self._rebucket_devices(job, err)):
                return  # re-enqueued on a smaller geometry bucket
            self._terminal(
                job, J.QUARANTINED,
                detail=detail.get("error")
                or {"detail": "quarantined on worker"},
            )
            return
        result = {
            "cycles": int(detail.get("max_core_cycles", 0)),
            "core_cycles": detail.get("core_cycles"),
            "steps": detail.get("steps"),
            "instructions": int(detail.get("instructions", 0)),
            "counters": detail.get("counters"),
        }
        if detail.get("attest"):
            # chain head rides the journaled result, same as the local
            # Scheduler's _element_result (fsck / offline audit hook)
            result["attest"] = detail["attest"]
        self.total_instructions += result["instructions"]
        self.completed += 1
        self._terminal(job, J.DONE, result=result, detail={
            "worker_mips": rec.get("value"),
            "resumed_steps": fin.get("resumed_steps", 0),
        })
        self._serve_event("retire", job_id=job.job_id, state=J.DONE,
                          remote=True)

    def _rebucket_devices(self, job: J.Job, err: dict) -> bool:
        """Degraded-mode elasticity (DESIGN.md §26): a worker could not
        host this job's mesh (devices revoked or too few visible), so the
        unit came back quarantined with a DeviceMeshError. Instead of
        quarantining the JOB, shrink the service's geometry bucket to the
        largest mesh the reported capacity can host and re-enqueue under
        a fresh unit id. False means the error is not recoverable this
        way (no smaller valid mesh) and the caller quarantines as before."""
        if not self.devices or self.devices <= 1:
            return False
        from ..parallel.sharding import DeviceMeshError, largest_valid_submesh

        loc = err.get("location") or {}
        try:
            visible = int(loc.get("visible"))
        except (TypeError, ValueError):
            visible = self.devices - 1
        try:
            n = largest_valid_submesh(self.cfg, min(visible, self.devices - 1))
        except DeviceMeshError:
            return False  # zero capacity reported: nothing to shrink to
        if n < 1 or n >= self.devices:
            return False
        prev, self.devices = self.devices, n
        self._rebucket_gen += 1
        alias = f"{job.job_id}r{self._rebucket_gen}"
        job._unit_alias = alias
        self.unit_aliases[alias] = job.job_id
        job.transition(J.PENDING)
        self.queue.append(job.job_id)
        self.journal.state(
            job.job_id, J.PENDING,
            detail={"rebucket": {"devices_from": prev, "devices_to": n}},
        )
        self._serve_event("rebucket", job_id=job.job_id,
                          devices_from=prev, devices_to=n)
        return True

    def _expire_deadlines(self, now: float) -> None:
        for job_id in list(self.queue):
            job = self.jobs[job_id]
            if job.deadline_expired(now):
                self.queue.remove(job_id)
                self._terminal(
                    job, J.TIMEOUT,
                    detail={"detail": f"deadline {job.deadline_s}s expired "
                                      "in queue"},
                )

    # ---- server-loop hooks ------------------------------------------------

    def pending_work(self) -> bool:
        return bool(self.queue) or bool(self.dispatched)

    def drain(self) -> int:
        """Graceful shutdown: journal the drain marker. In-flight units
        keep their coordinator-side checkpoints; the next front-end
        re-adopts them through idempotent enqueue. Returns the number of
        unfinished jobs."""
        unfinished = len(self.queue) + len(self.dispatched)
        self.journal.drain()
        return unfinished

    def checkpoint_running(self) -> None:
        """No-op in dispatch mode: workers own the element checkpoints
        (deterministic per-unit paths under the pool dir)."""

    def device_stats(self) -> dict:
        """The health reply's `device` field: where the children run. The
        front-end launches no kernel; each worker prints its launches on
        stderr when it exits."""
        return {"device": str(self.device), "remote": True}

    def shutdown_children(self, graceful: bool = True) -> None:
        """Retire the subprocesses this front-end spawned. Adopted
        coordinators are left alone — the standby that adopted them (or
        the next front-end) still needs them."""
        for w in self._workers:
            if w.poll() is None:
                (w.terminate if graceful else w.kill)()
        if self._coord_proc is not None and self._coord_proc.poll() is None:
            (self._coord_proc.terminate
             if graceful else self._coord_proc.kill)()
        deadline = time.time() + 5.0
        for p in [*self._workers, self._coord_proc]:
            if p is None:
                continue
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        self._workers = []
        self._coord_proc = None

    # ---- terminal bookkeeping / stats (Scheduler parity) ------------------

    def _terminal(self, job: J.Job, state: str, detail: dict | None = None,
                  result: dict | None = None) -> None:
        job.transition(state, detail=detail)
        if result is not None:
            job.result = result
        self.journal.state(job.job_id, state, detail=detail, result=result)
        if job.latency_s is not None:
            self._latencies.append(job.latency_s)
            self.latency_hist.observe(job.latency_s)
            if len(self._latencies) > 512:
                del self._latencies[:-512]

    def stats(self) -> dict:
        now = time.time()
        by_state = {s: 0 for s in J.STATES}
        for job in self.jobs.values():
            by_state[job.state] += 1
        lat = sorted(self._latencies)

        def pct(p):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)

        wall = max(now - self.started_t, 1e-9)
        live_workers = sum(1 for w in self._workers if w.poll() is None)
        return {
            "queue_depth": len(self.queue),
            "dispatched": len(self.dispatched),
            "slots": {
                # dispatch mode: "slots" are worker processes
                "total": self.max_workers,
                "occupied": live_workers,
                "buckets": [],
            },
            "workers": {
                "live": live_workers,
                "max": self.max_workers,
                "spawned": self._worker_seq,
                "coordinator_adopted": self.coordinator_adopted,
            },
            "jobs": by_state,
            "completed": self.completed,
            "aggregate_mips": round(
                self.total_instructions / wall / 1e6, 3
            ),
            "latency_s": {"p50": pct(0.50), "p90": pct(0.90),
                          "p99": pct(0.99)},
            "uptime_s": round(wall, 1),
            "last_dispatch_t": self.last_dispatch_t,
            "last_dispatch_age_s": (
                round(now - self.last_dispatch_t, 1)
                if self.last_dispatch_t else None
            ),
        }

    def service_report(self) -> dict:
        s = self.stats()
        return {
            "jobs_completed": s["completed"],
            "jobs_by_state": {k: v for k, v in s["jobs"].items() if v},
            "aggregate_mips": s["aggregate_mips"],
            "latency_s": s["latency_s"],
            "uptime_s": s["uptime_s"],
            "workers": s["workers"],
        }
