"""Continuous-batching scheduler: jobs in, fleet slots spliced, results
out. The JAX package's `serve/scheduler.py` for the port, on the port's
`FleetEngine.make_slots` (one set of kernel launches a step for a whole
bucket) and its element checkpoints.

The scheduler owns one compiled fleet program per CAPACITY BUCKET and
never recompiles during service. A bucket is `n_slots` batch elements
whose event storage is `n_pages * page_events` slots per core
(`FleetEngine.make_slots`); admission routes each job to the
smallest-capacity bucket its trace fits, so short traces don't pay the
worst-case [B, C, T] shape — the paged/pooled allocator the fleet's
fixed-shape splice contract makes possible.

One `tick()` is the serving round:

    expire deadlines -> splice pending jobs into free slots ->
    one committed chunk per busy bucket -> harvest retired elements ->
    periodic per-job element checkpoints

Every state transition is journaled BEFORE the slot is recycled, and
in-flight jobs are checkpointed to deterministic per-job paths
(`<dir>/jobs/<job_id>.npz`), so the restart path (server.py) can rebuild
exactly this table from the journal + checkpoint files alone.

Failure containment: a batch dispatch failure cannot be attributed to
one element from the exception, so the whole bucket rolls back — its
fleet is rebuilt all-idle (host arrays are authoritative) and each
occupant consults its `JobContext` retry budget: transient/oom failures
re-enqueue with exponential backoff (resuming from the newest element
checkpoint), permanent ones go FAILED. A job whose workload won't even
validate never reaches a fleet: it is QUARANTINED at admission, exactly
like `sweep --isolate` does for bad elements.

On the card a tick's device work is one chunk per busy bucket: its
launches and its one host transfer, plus, for a tick that splices or
retires, one transfer to re-read the bucket's live flags and the copy of
the spliced event rows (`upload_events`). A job's result record is
JAX's: cycles, per-core cycles, steps, instructions, all counters, and
its chain payload under `--attest chain`. The JAX bucket's executable
warm-up (`warm_exec`, the AOT cache) has nothing to do in the port: its
kernels build once per process.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..chaos import sites as chaos
from ..obs.metrics import Histogram
from ..sim.fleet import FleetEngine, apply_overrides
from ..sim.supervisor import JobContext, validate_fleet_element
from . import jobs as J
from .protocol import error_obj

#: One event-storage page, in per-core event slots. Bucket capacities are
#: whole pages: (slots, pages) -> capacity = pages * PAGE_EVENTS.
PAGE_EVENTS = 64

#: Default bucket ladder: small/large. Most synthetic traces fit one page.
DEFAULT_BUCKETS = ((6, 1), (2, 8))


class QueueFull(RuntimeError):
    """Admission refused: the bounded queue is at capacity. Carries the
    backpressure hint the protocol surfaces as `retry_after_s`."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"queue full ({depth} pending); retry after {retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s


class WorkloadSpecError(ValueError):
    """A job's workload SPEC (synth grammar / trace-vs-synth choice) is
    invalid. Subclasses ValueError so every existing quarantine path
    (`except ValueError` at the scheduler/server boundary) still
    catches it, but carries a `.location()` so the CLI and protocol can
    emit the structured {type, location, detail} error shape."""

    def __init__(self, msg: str, *, spec: str | None = None,
                 field: str | None = None):
        super().__init__(msg)
        self.spec = spec
        self.field = field

    def location(self) -> dict:
        loc: dict = {}
        if self.spec is not None:
            loc["spec"] = self.spec
        if self.field is not None:
            loc["field"] = self.field
        return loc


def parse_synth_spec(spec: str, n_cores: int, fold: bool):
    """`name:k=v,...` -> Trace (the CLI's --synth grammar, but raising
    WorkloadSpecError (a ValueError) instead of SystemExit so a bad
    spec quarantines the job with a structured error rather than
    killing the daemon)."""
    from ..trace import synth
    from ..trace.format import fold_ins

    name, _, args = spec.partition(":")
    if name not in synth.GENERATORS:
        raise WorkloadSpecError(
            f"unknown generator {name!r}; have: "
            f"{', '.join(sorted(synth.GENERATORS))}", spec=spec,
        )
    kw = {}
    if args:
        for pair in args.split(","):
            k, eq, v = pair.partition("=")
            if not eq or not k:
                raise WorkloadSpecError(
                    f"bad synth arg {pair!r} (want key=value)",
                    spec=spec, field=k or pair,
                )
            try:
                kw[k] = int(v)
            except ValueError:
                raise WorkloadSpecError(
                    f"bad synth arg {pair!r}: value must be an integer",
                    spec=spec, field=k,
                ) from None
    try:
        tr = synth.GENERATORS[name](n_cores, **kw)
    except TypeError as e:
        raise WorkloadSpecError(
            f"synth {name!r}: {e}", spec=spec
        ) from None
    return fold_ins(tr) if fold else tr


def materialize_workload(job: J.Job, cfg):
    """Load/generate the job's trace from its journaled SPEC and compute
    its effective config. Deterministic — re-running it after a crash
    yields the identical workload, which is what makes replay bit-exact.
    Raises (TraceError/ValueError/OSError) when the workload is bad; the
    caller quarantines."""
    from ..trace.format import Trace, fold_ins

    if (job.trace_path is None) == (job.synth is None):
        raise WorkloadSpecError(
            "job needs exactly one of trace_path | synth",
            field="trace_path|synth",
        )
    if job.trace_path is not None:
        tr = Trace.load(job.trace_path)
        if job.fold:
            tr = fold_ins(tr)
    else:
        tr = parse_synth_spec(job.synth, cfg.n_cores, job.fold)
    ecfg = apply_overrides(cfg, job.overrides)
    validate_fleet_element(cfg, tr, job.overrides)
    job._trace = tr
    job._elem_cfg = ecfg
    job._ctx = JobContext()
    return tr


class SlotBucket:
    """One compiled fleet + its slot table. `slots[i]` is the occupying
    Job or None; the fleet element under a None slot holds `idle_trace`
    and contributes nothing to the vmapped step."""

    def __init__(self, cfg, n_slots: int, n_pages: int,
                 chunk_steps: int = 128, obs=None, attest: bool = False,
                 device=None):
        self.cfg = cfg
        self.device = device
        self.n_slots = int(n_slots)
        self.n_pages = int(n_pages)
        self.capacity = int(n_pages) * PAGE_EVENTS
        self.chunk_steps = int(chunk_steps)
        self.obs = obs
        self.attest_on = bool(attest)
        self.fleet = self._make_fleet()
        self.slots: list[J.Job | None] = [None] * self.n_slots

    def _make_fleet(self):
        fleet = FleetEngine.make_slots(
            self.cfg, self.n_slots, self.capacity,
            chunk_steps=self.chunk_steps, device=self.device,
        )
        if self.attest_on:
            # per-slot fingerprint chains (DESIGN.md §24): slots are
            # tracked at splice and dropped at retire, so a job's chain
            # covers exactly its own chunks
            from ..attest import FleetAttest

            fleet.attest = FleetAttest()
        if self.obs is not None:
            # per-bucket timeline row: the recorder keys counter deltas
            # by label, so each bucket diffs against its own history
            self.obs.attach(fleet, label=f"bucket{self.n_pages}p")
        return fleet

    def free_slot(self) -> int | None:
        for i, occ in enumerate(self.slots):
            if occ is None:
                return i
        return None

    @property
    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def busy(self) -> bool:
        """Any occupied slot still running (not yet harvested)?"""
        if self.occupied == 0:
            return False
        dm = self.fleet.done_mask()
        return any(
            s is not None and not dm[i] for i, s in enumerate(self.slots)
        )

    def rebuild(self) -> None:
        """Host rollback after a failed dispatch: throw the (possibly
        poisoned) device state away and start an all-idle fleet on the
        same compiled geometry. Occupants must be re-enqueued by the
        caller BEFORE this runs."""
        self.fleet = self._make_fleet()
        self.slots = [None] * self.n_slots


class Scheduler:
    """The serving core. Owns the job table, the bounded pending queue,
    the bucket fleets, and the journal write side. Single-threaded by
    design — the server's listener threads only ENQUEUE closures onto
    `self.inbox`; every mutation happens on the tick loop."""

    def __init__(
        self,
        cfg,
        journal,
        state_dir: str,
        buckets=DEFAULT_BUCKETS,
        chunk_steps: int = 128,
        max_queue: int = 64,
        checkpoint_every_s: float = 2.0,
        max_retries: int = 2,
        obs=None,
        warm_cache: bool = False,
        attest: str = "off",
        device=None,
    ):
        self.cfg = cfg
        self.journal = journal
        self.obs = obs
        self.attest = str(attest or "off")
        # warm-state cache consult at admission (DESIGN.md §16): a
        # resubmitted (trace, config) job starts from the deepest cached
        # snapshot whose content key matches, instead of step 0
        if warm_cache:
            from ..sim.checkpoint import warm_cache_root

            self.warm_root = warm_cache_root()
        else:
            self.warm_root = None
        self.state_dir = str(state_dir)
        self.jobs_dir = os.path.join(self.state_dir, "jobs")
        os.makedirs(self.jobs_dir, exist_ok=True)
        self.buckets = [
            SlotBucket(cfg, n, p, chunk_steps=chunk_steps, obs=obs,
                       attest=self.attest == "chain", device=device)
            for n, p in sorted(buckets, key=lambda b: b[1])
        ]
        self.max_queue = int(max_queue)
        self.checkpoint_every_s = float(checkpoint_every_s)
        self.max_retries = int(max_retries)
        self.jobs: dict[str, J.Job] = {}
        self.queue: list[str] = []  # pending job_ids, accept order
        self._seq = 0
        self._last_pick: dict[str, int] = {}  # client -> rr stamp
        self._pick_n = 0
        self._last_ckpt_t = time.time()
        self._backoff_until = 0.0
        self.started_t = time.time()
        self.total_instructions = 0
        self.completed = 0
        self._latencies: list[float] = []  # terminal latencies, capped
        # always-on accept-to-terminal latency histogram (the Prometheus
        # surface) + last-dispatch stamp (health/metrics liveness signal)
        self.latency_hist = Histogram()
        self.last_dispatch_t: float | None = None
        # v2 paged allocator: slot migrations between capacity buckets
        self.promotions = 0
        self.demotions = 0
        # steps the buckets' fleets have run: each launches every kernel
        # of the step once for its whole batch
        self.fleet_steps = 0

    def _serve_event(self, kind: str, **args) -> None:
        if self.obs is not None:
            self.obs.serve_event(kind, args)

    # ---- identity / paths ------------------------------------------------

    def next_job_id(self) -> str:
        self._seq += 1
        return f"j{self._seq:06d}"

    def job_ckpt_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.npz")

    @property
    def total_slots(self) -> int:
        return sum(b.n_slots for b in self.buckets)

    @property
    def max_capacity(self) -> int:
        return max(b.capacity for b in self.buckets)

    # ---- admission -------------------------------------------------------

    def submit(self, job: J.Job) -> J.Job:
        """Admit one job: backpressure check, durable accept record
        (fsynced BEFORE this returns — the ACK invariant), workload
        validation (bad -> QUARANTINED), enqueue."""
        if len(self.queue) >= self.max_queue:
            raise QueueFull(
                len(self.queue), retry_after_s=1.0 + 0.1 * len(self.queue)
            )
        self.jobs[job.job_id] = job
        self.journal.accept(job)
        # the accept record is durable but the caller has NOT been told:
        # dying here is the lost-ACK window idempotency tokens cover
        chaos.crashpoint("server.post-journal-pre-ack")
        self._serve_event("admit", job_id=job.job_id, client=job.client,
                          priority=job.priority)
        self._validate_or_quarantine(job)
        if not job.terminal:
            self.queue.append(job.job_id)
        return job

    def _validate_or_quarantine(self, job: J.Job) -> bool:
        try:
            tr = materialize_workload(job, self.cfg)
        except Exception as e:  # bad workload must not kill the daemon
            self._terminal(job, J.QUARANTINED, detail=error_obj(e)["error"])
            return False
        if tr.max_len > self.max_capacity:
            self._terminal(
                job,
                J.QUARANTINED,
                detail={
                    "type": "CapacityError",
                    "location": {},
                    "detail": (
                        f"trace needs {tr.max_len} event slots/core; "
                        f"largest bucket holds {self.max_capacity}"
                    ),
                },
            )
            return False
        return True

    def requeue_recovered(self, job: J.Job) -> None:
        """Journal-replayed non-terminal job: re-materialize its workload
        from the accept facts, point it at its newest element checkpoint
        when one survived, and put it back in line."""
        self.jobs[job.job_id] = job
        if not self._validate_or_quarantine(job):
            return
        if os.path.exists(self.job_ckpt_path(job.job_id)):
            job._resume_from = self.job_ckpt_path(job.job_id)
        self.queue.append(job.job_id)

    def adopt_terminal(self, job: J.Job) -> None:
        """Journal-replayed job already in a terminal state: keep it for
        STATUS/RESULT queries; nothing to run."""
        self.jobs[job.job_id] = job

    def cancel(self, job_id: str) -> J.Job:
        job = self.jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        if job.terminal:
            raise ValueError(f"{job_id} already terminal ({job.state})")
        if job.state == J.PENDING and job_id in self.queue:
            self.queue.remove(job_id)
        elif job.state == J.RUNNING:
            self._evict(job)
        self._terminal(job, J.CANCELLED, detail={"detail": "client cancel"})
        return job

    # ---- the serving tick ------------------------------------------------

    def tick(self) -> bool:
        """One serving round. Returns True when any device work ran (the
        server idles its loop when False)."""
        now = time.time()
        self._expire_deadlines(now)
        if now >= self._backoff_until:
            self._fill_slots()
        worked = False
        for b in self.buckets:
            if not b.busy():
                continue
            chaos.crashpoint("scheduler.pre-dispatch")
            try:
                b.fleet.step_chunk()
                worked = True
                self.fleet_steps += b.fleet.chunk_steps
            except Exception as e:  # noqa: BLE001 — classified below
                self._dispatch_failed(b, e)
                return True
            chaos.crashpoint("scheduler.post-dispatch")
        self._harvest(now)
        # promotion check runs BETWEEN chunks: a windowed job must leave
        # its small bucket before the next chunk could reach the window
        # edge (see _promote_windows for the pointer-bound argument)
        self._promote_windows()
        if now - self._last_ckpt_t >= self.checkpoint_every_s:
            self.checkpoint_running()
            self._last_ckpt_t = now
            chaos.crashpoint("scheduler.post-checkpoint")
        return worked

    def pending_work(self) -> bool:
        """Anything admitted but not yet terminal — the server's busy
        signal for idle-exit and drain decisions."""
        return bool(self.queue) or any(b.occupied for b in self.buckets)

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
        for b in self.buckets:
            for i, job in enumerate(b.slots):
                if job is not None and job.deadline_expired(now):
                    self._evict(job)
                    self._terminal(
                        job, J.TIMEOUT,
                        detail={
                            "detail": f"deadline {job.deadline_s}s expired "
                                      f"after {int(self._slot_steps(job))} "
                                      "steps",
                        },
                    )

    def _pick_next(self, capacity: int) -> J.Job | None:
        """Highest priority first; per-client round-robin within a
        priority tier (a chatty client cannot starve others); accept
        order last. Only jobs whose trace fits `capacity`."""
        best = None
        best_key = None
        for job_id in self.queue:
            job = self.jobs[job_id]
            if job._trace is None or job._trace.max_len > capacity:
                continue
            key = (
                -job.priority,
                self._last_pick.get(job.client, -1),
                job.accepted_t,
            )
            if best_key is None or key < best_key:
                best, best_key = job, key
        return best

    def _fill_slots(self) -> None:
        """Splice pending jobs into free slots, smallest-fitting bucket
        first; one deferred `upload_events` per bucket covers the whole
        batch of splices. Two passes per bucket (v2 paged allocator):
        full-fit jobs first, then WINDOW admissions — an oversized job's
        leading `capacity-1` events run in the small bucket now and the
        job migrates up by checkpoint before the window edge matters."""
        self._demote_for_queued()
        for b in self.buckets:
            spliced = False
            while True:
                i = b.free_slot()
                if i is None:
                    break
                job = self._pick_next(b.capacity)
                if job is None:
                    break
                self.queue.remove(job.job_id)
                self._pick_n += 1
                self._last_pick[job.client] = self._pick_n
                self._place(b, i, job, upload=False)
                spliced = True
            if spliced:
                b.fleet.upload_events()
        # window pass, all buckets — runs only after every full-fit
        # splice, so a job starts windowed only when no bucket that fully
        # fits it has a free slot
        for b in self.buckets:
            spliced = False
            while True:
                i = b.free_slot()
                if i is None:
                    break
                job = self._pick_window(b)
                if job is None:
                    break
                self.queue.remove(job.job_id)
                self._pick_n += 1
                self._last_pick[job.client] = self._pick_n
                job._window = self._window_trace(job._trace, b.capacity)
                self._place(b, i, job, upload=False)
                spliced = True
            if spliced:
                b.fleet.upload_events()

    # ---- v2 paged allocator: windows + bucket migration ------------------

    def _window_trace(self, tr, capacity: int):
        """The leading `capacity-1` events of each core's row, with a
        FORCED END at index capacity-1 for every core that was truncated.
        The promotion bound keeps every trace pointer strictly below that
        index, so the forced END is never consumed and the windowed
        element's state stays bit-identical to a full-trace run."""
        from ..trace.format import EV_END, Trace

        keep = capacity - 1
        n_cores = tr.events.shape[0]
        ev = np.zeros((n_cores, capacity, 4), np.int32)
        ev[:, :, 0] = EV_END
        ev[:, :keep] = tr.events[:, :keep]
        lengths = np.where(
            tr.lengths > keep, keep + 1, tr.lengths
        ).astype(np.int32)
        return Trace(ev, lengths, line_addressed=tr.line_addressed,
                     line_bits=tr.line_bits)

    def _window_ok(self, job: J.Job, b: SlotBucket) -> bool:
        """May `job` run its leading window in bucket `b`? Requires: the
        full trace does NOT fit b (else pass 1 handles it) but DOES fit
        some bucket (else quarantined at admission); no checkpoint resume
        pending (a snapshot taken past the window edge cannot replay
        inside it); a window deep enough to outlast one chunk; and no
        sync events — a barrier truncated out of one core's window would
        deadlock the cores that kept it."""
        tr = job._trace
        if tr is None or tr.max_len <= b.capacity:
            return False
        if tr.max_len > self.max_capacity:
            return False
        if job._resume_from is not None:
            return False
        if b.capacity - 1 <= b.chunk_steps:
            return False
        if any(sb.capacity >= tr.max_len and sb.free_slot() is not None
               for sb in self.buckets):
            return False  # a full-fit slot is free; windowing would waste it
        if job._has_sync is None:
            from ..trace.format import SYNC_TYPES

            job._has_sync = bool(
                np.isin(tr.events[:, :, 0], SYNC_TYPES).any()
            )
        return not job._has_sync

    def _pick_window(self, b: SlotBucket) -> J.Job | None:
        """Window-admission pick: same fairness key as _pick_next, over
        jobs whose full trace does not fit this bucket."""
        best = None
        best_key = None
        for job_id in self.queue:
            job = self.jobs[job_id]
            if not self._window_ok(job, b):
                continue
            key = (
                -job.priority,
                self._last_pick.get(job.client, -1),
                job.accepted_t,
            )
            if best_key is None or key < best_key:
                best, best_key = job, key
        return best

    def _migrate_out(self, b: SlotBucket, i: int, job: J.Job,
                     why: str) -> None:
        """Checkpoint-evict a RUNNING occupant back to the queue head so
        the next fill re-splices it elsewhere and it resumes mid-run.
        The snapshot is fingerprinted against the FULL trace — machine
        state is geometry-shaped, not capacity-shaped, so it restores
        into any bucket."""
        from ..sim.checkpoint import save_element_checkpoint

        path = self.job_ckpt_path(job.job_id)
        save_element_checkpoint(path, b.fleet, i, job_id=job.job_id,
                                trace=job._trace)
        b.fleet.clear_element(i)
        b.slots[i] = None
        job._window = None
        job._resume_from = path
        job.transition(J.PENDING)
        self.queue.insert(0, job.job_id)
        self.journal.state(
            job.job_id, J.PENDING,
            detail={"detail": why, "migrated": True,
                    "from_pages": b.n_pages},
        )

    def _promote_windows(self) -> None:
        """Migrate windowed jobs UP before the window edge can matter.
        Bound: a chunk advances any trace pointer by at most chunk_steps
        (one event per core per step), so promoting whenever
        max(ptr) >= keep - chunk_steps after a chunk guarantees
        ptr <= keep-1 always — the forced END at `keep` is never read,
        and the promoted job resumes from state a full-trace run would
        have produced identically."""
        for b in self.buckets:
            for i, job in enumerate(b.slots):
                if job is None or job._window is None:
                    continue
                keep = b.capacity - 1
                ptr = int(b.fleet.state.ptr[i].max())
                if ptr < keep - b.chunk_steps:
                    continue
                steps = int(b.fleet.steps_run[i])
                self._migrate_out(
                    b, i, job,
                    f"promoted out of {b.n_pages}p window at event {ptr}",
                )
                self.promotions += 1
                self._serve_event("promote", job_id=job.job_id,
                                  from_pages=b.n_pages, ptr=ptr,
                                  steps=steps)

    def _demote_for_queued(self) -> None:
        """Starvation valve (at most one migration per tick): a queued
        job that only fits the larger buckets is blocked while they are
        full; if one of their occupants would fully fit a FREE smaller
        slot, checkpoint-migrate the occupant down and free the big
        slot."""
        blocked = None
        for job_id in self.queue:
            q = self.jobs[job_id]
            if q._trace is None:
                continue
            fitting = [b for b in self.buckets
                       if b.capacity >= q._trace.max_len]
            if fitting and all(b.free_slot() is None for b in fitting):
                blocked = q
                break
        if blocked is None:
            return
        for b in reversed(self.buckets):  # largest candidates first
            if b.capacity < blocked._trace.max_len:
                continue
            for i, occ in enumerate(b.slots):
                if occ is None or occ._window is not None:
                    continue
                target = next(
                    (sb for sb in self.buckets
                     if sb.capacity < b.capacity
                     and sb.capacity >= occ._trace.max_len
                     and sb.free_slot() is not None),
                    None,
                )
                if target is None:
                    continue
                self._migrate_out(
                    b, i, occ,
                    f"demoted from {b.n_pages}p to {target.n_pages}p "
                    f"to unblock {blocked.job_id}",
                )
                self.demotions += 1
                self._serve_event("demote", job_id=occ.job_id,
                                  from_pages=b.n_pages,
                                  to_pages=target.n_pages,
                                  unblocks=blocked.job_id)
                return

    def _place(self, b: SlotBucket, i: int, job: J.Job,
               upload: bool = True) -> None:
        from ..sim.checkpoint import load_element_checkpoint

        b.fleet.replace_element(
            i,
            job._window if job._window is not None else job._trace,
            base_cfg=job._elem_cfg,
            upload=upload,
        )
        resumed = False
        warm_steps = 0
        ckpt_attest = None
        if job._resume_from:
            try:
                snap = load_element_checkpoint(
                    job._resume_from, job._elem_cfg, job._trace,
                    device=b.fleet.device,
                )
                b.fleet.restore_element(i, snap)
                ckpt_attest = snap.get("attest")
                resumed = True
            except Exception as e:  # corrupt/mismatched ckpt: fresh start
                self.journal.note(
                    f"{job.job_id}: element checkpoint unusable "
                    f"({type(e).__name__}: {e}); restarting from step 0"
                )
        if not resumed and self.warm_root is not None \
                and job._window is None:
            # (windowed splices skip the warm cache: a warm state's trace
            # pointer may already sit past the window edge)
            # no mid-run checkpoint of its own: check the warm cache. The
            # content key proves the first `steps` steps of this exact
            # (trace, config) workload; fork_element reseeds the traced
            # fault inputs so a schedule/seed difference past the prefix
            # stays the job's own
            from ..sim.checkpoint import (
                CheckpointCorrupt,
                find_warm_states,
                load_warm_state,
                trace_fingerprint,
            )

            fp = trace_fingerprint(job._trace)
            for steps, key in find_warm_states(
                self.warm_root, job._elem_cfg, fp
            ):
                if steps >= job.max_steps:
                    continue  # would overshoot the job's step budget
                try:
                    snap = load_warm_state(
                        self.warm_root, key, job._elem_cfg, fp, steps,
                        device=b.fleet.device,
                    )
                except (FileNotFoundError, CheckpointCorrupt, ValueError) as e:
                    self.journal.note(
                        f"{job.job_id}: warm entry {key[:12]} unusable "
                        f"({type(e).__name__}); trying next"
                    )
                    continue
                b.fleet.fork_element(i, snap, cache_key=key)
                warm_steps = steps
                self.journal.note(
                    f"{job.job_id}: admitted from warm cache at step "
                    f"{steps} (key {key[:12]})"
                )
                if self.obs is not None:
                    self.obs.prefix_event(
                        "warm-hit", job_id=job.job_id, key=key, steps=steps
                    )
                break
        if b.fleet.attest is not None:
            # continue a checkpointed chain when the cadence still
            # matches; otherwise the chain restarts at the boundary the
            # slot resumes from (migration, warm fork, fresh start) and
            # `comparable()` keeps it from false-matching a full run
            cs = b.chunk_steps
            if ckpt_attest and ckpt_attest.get("head") \
                    and int(ckpt_attest.get("chunk_steps", 0)) == cs:
                b.fleet.attest.track(
                    i, cs, start=int(ckpt_attest.get("start", 0)),
                    head=ckpt_attest["head"],
                    chunks=int(ckpt_attest.get("chunks", 0)),
                )
            else:
                b.fleet.attest.track(
                    i, cs, start=int(b.fleet.steps_run[i])
                )
        b.slots[i] = job
        job.attempts += 1
        job.transition(J.RUNNING)
        self.last_dispatch_t = time.time()
        self.journal.state(
            job.job_id, J.RUNNING,
            detail={"attempt": job.attempts, "resumed": resumed,
                    "warm_steps": warm_steps,
                    "bucket_pages": b.n_pages, "slot": i,
                    "window": job._window is not None},
        )
        self._serve_event("dispatch", job_id=job.job_id, slot=i,
                          bucket_pages=b.n_pages, attempt=job.attempts,
                          resumed=resumed, warm_steps=warm_steps,
                          window=job._window is not None)

    def _slot_of(self, job: J.Job) -> tuple[SlotBucket, int] | None:
        for b in self.buckets:
            for i, occ in enumerate(b.slots):
                if occ is job:
                    return b, i
        return None

    def _slot_steps(self, job: J.Job) -> int:
        loc = self._slot_of(job)
        if loc is None:
            return 0
        b, i = loc
        return int(b.fleet.steps_run[i])

    def _evict(self, job: J.Job) -> None:
        """Free a RUNNING job's slot without journaling (caller decides
        the terminal record)."""
        loc = self._slot_of(job)
        if loc is not None:
            b, i = loc
            b.fleet.clear_element(i)
            b.slots[i] = None

    def _harvest(self, now: float) -> None:
        for b in self.buckets:
            if b.occupied == 0:
                continue
            dm = b.fleet.done_mask()
            cleared = False
            for i, job in enumerate(b.slots):
                if job is None:
                    continue
                if dm[i]:
                    result = self._element_result(b, i)
                    b.fleet.clear_element(i, upload=False)
                    b.slots[i] = None
                    cleared = True
                    self.total_instructions += result["instructions"]
                    self.completed += 1
                    self._terminal(job, J.DONE, result=result)
                    self._serve_event("retire", job_id=job.job_id,
                                      state=J.DONE,
                                      steps=result["steps"],
                                      instructions=result["instructions"])
                    self._drop_ckpt(job.job_id)
                elif int(b.fleet.steps_run[i]) >= job.max_steps:
                    steps = int(b.fleet.steps_run[i])
                    b.fleet.clear_element(i, upload=False)
                    b.slots[i] = None
                    cleared = True
                    self._terminal(
                        job, J.QUARANTINED,
                        detail={
                            "type": "StepBudget",
                            "location": {},
                            "detail": f"step budget {job.max_steps} "
                                      f"exhausted at {steps} steps "
                                      "(deadlock?)",
                        },
                    )
                    self._serve_event("retire", job_id=job.job_id,
                                      state=J.QUARANTINED, steps=steps)
                    self._drop_ckpt(job.job_id)
            if cleared:
                b.fleet.upload_events()

    def _element_result(self, b: SlotBucket, i: int) -> dict:
        """The job's result record: per-core cycles and counters, exactly
        what a solo Engine run of (elem_cfg, trace) reports — the
        bit-exactness contract the tests pin."""
        cyc = b.fleet.cycles[i]
        counters = b.fleet.element_counters(i)
        res = {
            "cycles": int(cyc.max()),
            "core_cycles": [int(c) for c in cyc],
            "steps": int(b.fleet.steps_run[i]),
            "instructions": int(counters["instructions"].sum()),
            "counters": {
                k: [int(x) for x in v] for k, v in counters.items()
            },
        }
        if b.fleet.attest is not None:
            # the chain head rides the journaled result record, so fsck
            # can cross-check it against the job's last element
            # checkpoint and `primetpu audit` can re-derive it offline
            at = b.fleet.attest.payload(i)
            if at is not None:
                res["attest"] = at
        return res

    # ---- failure / retry -------------------------------------------------

    def _dispatch_failed(self, b: SlotBucket, exc: BaseException) -> None:
        """A chunk dispatch failed. The exception cannot name the guilty
        element, so the bucket rolls back wholesale: every occupant
        spends one retry (with backoff + checkpoint resume) or goes
        FAILED, then the fleet is rebuilt all-idle."""
        occupants = [j for j in b.slots if j is not None]
        self._serve_event("rollback", bucket_pages=b.n_pages,
                          error=type(exc).__name__,
                          occupants=len(occupants))
        self.journal.note(
            f"bucket[{b.n_pages}p] dispatch failed with "
            f"{type(exc).__name__}: {exc}; rolling back "
            f"{len(occupants)} occupant(s)"
        )
        max_delay = 0.0
        for job in occupants:
            delay = job._ctx.next_retry(exc) if job._ctx else None
            if delay is None:
                job.transition(J.FAILED, detail=error_obj(exc)["error"])
                job.detail["retry_log"] = list(job._ctx.log) if job._ctx \
                    else []
                self.journal.state(
                    job.job_id, J.FAILED, detail=job.detail
                )
                self._finish_stats(job)
                self._drop_ckpt(job.job_id)
            else:
                max_delay = max(max_delay, delay)
                job.transition(J.PENDING)
                if os.path.exists(self.job_ckpt_path(job.job_id)):
                    job._resume_from = self.job_ckpt_path(job.job_id)
                self.queue.append(job.job_id)
                self.journal.state(
                    job.job_id, J.PENDING,
                    detail={"detail": "re-enqueued after dispatch failure"},
                )
        b.rebuild()
        self._backoff_until = time.time() + max_delay

    # ---- durability ------------------------------------------------------

    def checkpoint_running(self) -> None:
        """Element-checkpoint every RUNNING job to its deterministic
        per-job path (atomic tmp+rename, so a crash mid-save leaves the
        previous checkpoint intact)."""
        from ..sim.checkpoint import save_element_checkpoint
        from ..util.diskpressure import DiskPressureError

        for b in self.buckets:
            for i, job in enumerate(b.slots):
                if job is not None:
                    try:
                        # fingerprint the FULL trace even for windowed
                        # elements: recovery re-materializes the full
                        # trace and must accept this snapshot
                        save_element_checkpoint(
                            self.job_ckpt_path(job.job_id), b.fleet, i,
                            job_id=job.job_id, trace=job._trace,
                        )
                    except DiskPressureError as e:
                        # a skipped cadence checkpoint only widens this
                        # job's recovery replay window; the job itself —
                        # and every ACKed record — is untouched
                        self._serve_event(
                            "disk-pressure", job_id=job.job_id,
                            detail=str(e),
                        )
                        continue
                    self._serve_event(
                        "checkpoint", job_id=job.job_id,
                        steps=int(b.fleet.steps_run[i]),
                    )

    def _drop_ckpt(self, job_id: str) -> None:
        try:
            os.unlink(self.job_ckpt_path(job_id))
        except OSError:
            pass

    def drain(self) -> int:
        """Graceful shutdown: checkpoint every in-flight job so the next
        server resumes it mid-run, then journal the clean-drain marker.
        Returns the number of jobs left unfinished (pending+running)."""
        self.checkpoint_running()
        unfinished = len(self.queue)
        for b in self.buckets:
            for job in b.slots:
                if job is not None:
                    unfinished += 1
        self.journal.drain()
        return unfinished

    # ---- terminal bookkeeping / stats ------------------------------------

    def _terminal(self, job: J.Job, state: str, detail: dict | None = None,
                  result: dict | None = None) -> None:
        job.transition(state, detail=detail)
        if result is not None:
            job.result = result
        self.journal.state(job.job_id, state, detail=detail, result=result)
        self._finish_stats(job)

    def _finish_stats(self, job: J.Job) -> None:
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
        return {
            "queue_depth": len(self.queue),
            "slots": {
                "total": self.total_slots,
                "occupied": sum(b.occupied for b in self.buckets),
                "buckets": [
                    {
                        "pages": b.n_pages,
                        "capacity_events": b.capacity,
                        "slots": b.n_slots,
                        "occupied": b.occupied,
                    }
                    for b in self.buckets
                ],
            },
            "jobs": by_state,
            "completed": self.completed,
            "migrations": {"promotions": self.promotions,
                           "demotions": self.demotions},
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

    def device_stats(self) -> dict:
        """The process's device work: fleet steps run, kernel launches
        (`kernels/build.py::LAUNCHES`: the card's, 0 on the CPU) and, on a
        card, its peak allocated memory."""
        import torch

        from ..kernels.build import LAUNCHES

        out = {"fleet_steps": self.fleet_steps, "kernel_launches": dict(LAUNCHES)}
        dev = self.buckets[0].fleet.device
        if dev.type == "cuda":
            out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        return out

    def service_report(self) -> dict:
        """The SERVICE section for stats.report.render_report."""
        s = self.stats()
        return {
            "jobs_completed": s["completed"],
            "jobs_by_state": {k: v for k, v in s["jobs"].items() if v},
            "aggregate_mips": s["aggregate_mips"],
            "latency_s": s["latency_s"],
            "uptime_s": s["uptime_s"],
        }
