"""Resilient execution layer (DESIGN.md §10): the JAX package's
`sim/supervisor.py` for the port's solo `Engine`, its `FleetEngine` and
its `StreamEngine`.

`RunSupervisor` drives an engine to completion chunk by committed chunk
through the engine's own `run_steps` (a stream: one window,
`_advance_window`, is one committed chunk, and a snapshot is a stream
snapshot), so supervised results are bit-exact with unsupervised ones,
and adds:

- **rotating atomic snapshots**: `ckpt-<seq>.npz` files written through
  `checkpoint.atomic_save_npz` (the JAX package's format, so a snapshot
  of either package's supervisor resumes in the other); `resume()` walks
  them newest first and falls back past any that raise
  `CheckpointCorrupt`. Cadence: every K committed chunks and/or W
  wall-seconds; a disk that stays full skips a rotation instead of
  killing the run.
- **preemption**: SIGTERM/SIGINT set a flag; at the next committed chunk
  boundary the supervisor checkpoints and raises `Preempted`.
- **retry with decorrelated jitter**: failures whose text carries a
  transient status (UNAVAILABLE, DEADLINE_EXCEEDED, ...) are retried;
  OOM (RESOURCE_EXHAUSTED, torch's "CUDA out of memory") first halves
  `chunk_steps`, which changes only the drain/rebase cadence, never
  results. After `max_retries` the supervisor logs `give-up` and
  re-raises: where the JAX supervisor would move the run to its CPU
  backend, the port does not fall back to a device it was not asked to
  use.
- **an on-device rollback**: the port's step is not functional.
  `commit_step` updates the L1, the directory and the step counters in
  place, and the fault scrub rewrites the directory in place, so a chunk
  that fails after doing its work has already changed the tensors the
  state before it holds. Before each attempt the supervisor therefore
  keeps a device-to-device copy of the whole state (the batched state of
  a fleet), with the host's counters, clocks and step counts (and a
  stream's cursors); a failed
  attempt gets that copy back, bit for bit, and the engine re-derives its
  host caches from it. One state's bytes and one copy a chunk, on the
  supervised path only.
- **a post-chunk invariant guard**: `guard="off"|"warn"|"fail"` runs
  `validate.check_chunk_invariants` (MESI/directory consistency, the
  clock window, monotone counters) on every committed chunk.
- **chaos narration**: under an armed fault model the supervisor logs
  the schedule and every fault-counter movement at chunk boundaries.

An engine's attestation chain (`engine.attest`) rolls back with its
state: the snapshot before each attempt keeps the chain's head and
count, so a retried chunk is never linked twice, and an OOM halving
records the new cadence on the chain (`note_cadence`), which makes it
incomparable to a full-cadence chain instead of falsely divergent.

The chaos revocation site (`devices.revoke`) is reached at every chunk
boundary, as in the JAX supervisor; the port runs on one card, so its
pool of healthy devices is that card alone, a revocation has nothing to
take, and the event is counted and logged but changes nothing, as on a
one-device JAX backend. Not ported yet: the device-loss reshard ladder
(a `device_loss` failure takes the transient path, as the JAX supervisor
does when there is nothing to demote) and the overlapped-dispatch
discard.

`validate_fleet_element` and `build_fleet_isolated` quarantine a sweep's
malformed elements before batching.
"""

from __future__ import annotations

import os
import re
import signal
import time

import numpy as np
import torch

from ..chaos import sites as chaos_sites
from ..trace.format import validate_sync
from .checkpoint import CheckpointCorrupt
from .state import leaves, map_state
from .validate import check_chunk_invariants


class Preempted(RuntimeError):
    """A SIGTERM/SIGINT arrived mid-run; the supervisor committed the
    current chunk, wrote a snapshot (`.checkpoint`, None when no snapshot
    dir was configured), and stopped cleanly. Rerun with `--resume` to
    continue bit-exactly."""

    def __init__(self, message: str, checkpoint: str | None = None,
                 signum: int | None = None):
        super().__init__(message)
        self.checkpoint = checkpoint
        self.signum = signum


class GuardViolation(RuntimeError):
    """`guard="fail"`: a post-chunk invariant check failed. The run
    stopped BEFORE checkpointing the bad state."""


# The JAX package's marker lists, unchanged: its runtime embeds gRPC-style
# status names in the message. Of torch's CUDA errors only "CUDA out of
# memory" matches (as "out of memory"); the others carry no status name
# and are permanent.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "INTERNAL",
    "CANCELLED",
    "failed to connect",
    "Socket closed",
    "DiskPressureError",
)
_DEVICE_LOSS_MARKERS = (
    "DEVICE_LOST",
    "device lost",
    "Device lost",
    "device unhealthy",
    "DeviceMeshError",
    "chip unreachable",
    "heartbeat timeout on device",
)


def classify_failure(exc: BaseException) -> str | None:
    """'device_loss' | 'oom' | 'transient' | None (permanent) for an engine
    dispatch failure. Deliberate errors (ValueError config/trace
    mismatches, AssertionError invariants, KeyboardInterrupt) are never
    retried; device loss is checked first, as in the JAX package."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return None
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _DEVICE_LOSS_MARKERS):
        return "device_loss"
    if isinstance(exc, (AssertionError, ValueError)):
        return None
    if any(m in text for m in _OOM_MARKERS):
        return "oom"
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "transient"
    return None


class JobContext:
    """Per-job supervision context: the retry policy RunSupervisor applies
    per chunk, scoped to one job's lifetime. `next_retry(exc)` returns the
    backoff delay for another attempt, or None when the job must move to a
    terminal state (permanent error, or the budget is spent); every
    decision lands in `log`."""

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.5):
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.attempts = 0
        self.log: list[str] = []

    def next_retry(self, exc: BaseException) -> float | None:
        kind = classify_failure(exc)
        if kind is None:
            self.log.append(f"permanent: {type(exc).__name__}: {exc}")
            return None
        if self.attempts >= self.max_retries:
            self.log.append(
                f"give-up: {kind} failure persisted after "
                f"{self.max_retries} retries: {exc}"
            )
            return None
        self.attempts += 1
        delay = min(self.backoff_s * (2 ** (self.attempts - 1)), 30.0)
        self.log.append(
            f"retry {self.attempts}/{self.max_retries} after {kind} "
            f"failure ({exc}); backoff {delay:.2f}s"
        )
        return delay


_SNAP_RE = re.compile(r"ckpt-(\d{8})\.npz")


class SnapshotStore:
    """Rotating checkpoint directory: `ckpt-<seq:08d>.npz`, newest wins,
    oldest pruned past `keep`. Sequence numbers only grow, so "latest" is
    a filename sort, never an mtime comparison. Registers the rotated
    snapshots (never the newest) as a priority-1 disk-pressure evictor."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = max(1, int(keep))
        os.makedirs(self.dir, exist_ok=True)
        from ..util import diskpressure

        diskpressure.register_evictor(
            f"snapshots:{self.dir}", self._evict_rotated, priority=1
        )

    def _evict_rotated(self, need_bytes: int) -> int:
        removed = 0
        for p in self.snapshots()[1:]:
            try:
                os.unlink(p)
                removed += 1
            except OSError:
                pass
        return removed

    def snapshots(self) -> list[str]:
        """Snapshot paths, newest (highest sequence) first."""
        found = []
        for name in os.listdir(self.dir):
            m = _SNAP_RE.fullmatch(name)
            if m:
                found.append((int(m.group(1)), os.path.join(self.dir, name)))
        return [p for _, p in sorted(found, reverse=True)]

    def save(self, save_fn) -> str:
        """Write the next snapshot via `save_fn(path)` (the engines'
        atomic `save_checkpoint`), then prune."""
        snaps = self.snapshots()
        seq = (
            int(_SNAP_RE.fullmatch(os.path.basename(snaps[0])).group(1)) + 1
            if snaps
            else 1
        )
        path = os.path.join(self.dir, f"ckpt-{seq:08d}.npz")
        save_fn(path)
        for p in self.snapshots()[self.keep:]:
            try:
                os.unlink(p)
            except OSError:
                pass
        return path


def _host_state(st):
    """The state with every plain field copied to the host once (the
    guard's checks take several views of the directory)."""
    return st._replace(**{f: getattr(st, f).cpu() for f in st._fields
                          if f not in ("knobs", "faults")})


class RunSupervisor:
    """Drive a solo `Engine`, a `FleetEngine` or a `StreamEngine` to
    completion chunk by chunk (module docstring). `on_chunk(supervisor)` fires after every
    committed chunk, before the guard and preemption checks: the
    deterministic injection point of the crash-recovery tests."""

    def __init__(
        self,
        engine,
        snapshot_dir: str | None = None,
        keep_snapshots: int = 3,
        checkpoint_every_chunks: int = 0,
        checkpoint_every_s: float = 0.0,
        guard: str = "off",
        max_retries: int = 4,
        backoff_s: float = 0.5,
        handle_signals: bool = True,
        on_chunk=None,
        obs=None,
    ):
        if guard not in ("off", "warn", "fail"):
            raise ValueError(f"guard must be off|warn|fail, got {guard!r}")
        self.engine = engine
        self.kind = (
            "stream"
            if hasattr(engine, "_advance_window")
            else "fleet" if hasattr(engine, "elem_cfgs") else "solo"
        )
        self.store = (
            SnapshotStore(snapshot_dir, keep_snapshots) if snapshot_dir else None
        )
        self.checkpoint_every_chunks = int(checkpoint_every_chunks)
        self.checkpoint_every_s = float(checkpoint_every_s)
        self.guard = guard
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.handle_signals = handle_signals
        self.on_chunk = on_chunk
        # telemetry sink (obs.Recorder): supervision events are mirrored
        # onto its "supervisor" timeline row
        self.obs = obs
        self.committed = 0  # chunks committed under this supervisor
        self.retries = 0
        self.guard_warnings = 0
        self.checkpoints_written = 0
        self.resumed_from: str | None = None
        self.stalled_elements: list[int] = []  # fleet: budget-exhausted
        self._stream_finished = False  # stream: the last window finished it
        # the rollback copy: bytes of one copy of the device state, and
        # copies taken (one per attempt at a chunk)
        self.rollback_bytes = 0
        self.rollback_copies = 0
        self._events_log: list[tuple[float, str, str]] = []
        self._t0 = time.monotonic()
        self._preempt: int | None = None
        self._prev_handlers: dict = {}
        self._prev_totals: dict[str, int] | None = None
        # the JAX package's device-loss ladder rungs; none in the port yet
        self.degrade_rungs: list[str] = []
        cfg = getattr(engine, "cfg", None)
        self._chaos = bool(getattr(cfg, "faults_enabled", False))
        self._fault_seen: dict[str, int] = {}

    # ---- logging --------------------------------------------------------

    def _log(self, kind: str, msg: str) -> None:
        self._events_log.append((time.monotonic() - self._t0, kind, msg))
        if self.obs is not None:
            self.obs.supervisor_event(kind, msg)

    def log_lines(self) -> list[str]:
        """Human-readable supervision log (rendered into the report)."""
        return [
            f"[+{t:7.1f}s] {kind}: {msg}" for t, kind, msg in self._events_log
        ]

    def summary(self) -> dict:
        return {
            "supervised": True,
            "committed_chunks": self.committed,
            "checkpoints_written": self.checkpoints_written,
            "resumed_from": self.resumed_from,
            "retries": self.retries,
            "guard": self.guard,
            "guard_warnings": self.guard_warnings,
            "stalled_elements": self.stalled_elements,
            "degrade_rungs": list(self.degrade_rungs),
        }

    # ---- snapshots ------------------------------------------------------

    def checkpoint(self) -> str | None:
        """Write the next rotating snapshot (None without a store). Disk
        pressure that survives the whole evict+compact ladder skips THIS
        rotation instead of killing the run."""
        if self.store is None:
            return None
        from ..util.diskpressure import DiskPressureError

        try:
            path = self.store.save(self.engine.save_checkpoint)
        except DiskPressureError as e:
            self._log("disk-pressure", f"snapshot skipped: {e}")
            return None
        self.checkpoints_written += 1
        self._log("checkpoint", os.path.basename(path))
        return path

    def resume(self) -> str | None:
        """Restore the newest VALID snapshot into the engine. Corrupt
        snapshots are skipped with a log entry; config/trace mismatches
        propagate (resuming the wrong run silently is worse than dying).
        Returns the restored path, or None for an empty directory."""
        if self.store is None:
            raise ValueError("resume() requires a snapshot_dir")
        snaps = self.store.snapshots()
        if not snaps:
            self._log("resume", "no snapshots found; starting fresh")
            return None
        for path in snaps:
            try:
                self.engine.load_checkpoint(path)
            except CheckpointCorrupt as e:
                self._log(
                    "resume-skip",
                    f"{os.path.basename(path)} invalid, trying older ({e})",
                )
                continue
            self.resumed_from = path
            self._log("resume", f"resumed from {os.path.basename(path)}")
            # a forked run's snapshot is self-describing: put "this run
            # never simulated steps 0..P itself" on the record
            pre = getattr(self.engine, "prefix_steps", None)
            forked = int(np.asarray(pre).max()) if pre is not None else 0
            if forked > 0:
                self._log(
                    "resume-prefix",
                    f"restored state carries prefix-fork provenance "
                    f"(max prefix_steps={forked})",
                )
            return path
        raise CheckpointCorrupt(
            f"{self.store.dir}: all {len(snaps)} snapshots are corrupt"
        )

    # ---- signals --------------------------------------------------------

    def _on_signal(self, signum, frame) -> None:
        if self._preempt is not None:
            # second signal: the operator is insisting — die now
            raise KeyboardInterrupt
        self._preempt = signum

    def _install_signals(self) -> None:
        if not self.handle_signals:
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread
                pass

    def _restore_signals(self) -> None:
        for sig, h in self._prev_handlers.items():
            signal.signal(sig, h)
        self._prev_handlers = {}

    # ---- engine surface (kind dispatch) ---------------------------------

    def _done(self) -> bool:
        if self.kind == "stream":
            return self._stream_finished or self.engine.done()
        return self.engine.done()

    def _steps_used(self) -> int:
        if self.kind == "fleet":
            return int(self.engine.steps_run.max())
        return int(self.engine.steps_run)

    def _counter_totals(self) -> dict[str, int]:
        return {
            k: int(np.asarray(v).sum())
            for k, v in self.engine.host_counters.items()
        }

    def _snapshot(self) -> dict:
        """Everything a chunk may change: a device-to-device copy of the
        whole state (the step updates the L1, the directory and the
        counters in place) and copies of the host's accumulators."""
        eng = self.engine
        state = map_state(torch.clone, eng.state)
        if not self.rollback_bytes:
            self.rollback_bytes = sum(x.numel() * x.element_size() for x in leaves(state))
        self.rollback_copies += 1
        snap = {
            "state": state,
            "steps_run": np.copy(eng.steps_run) if self.kind == "fleet" else eng.steps_run,
            "cycle_base": np.copy(eng.cycle_base) if self.kind == "fleet" else eng.cycle_base,
            "host_counters": {k: v.copy() for k, v in eng.host_counters.items()},
        }
        if self.kind == "stream":
            snap["cursor"] = eng.cursor.copy()
            snap["window_chunks"] = list(eng.window_chunks)
        if getattr(eng, "attest", None) is not None:
            # the chain must roll back with the state it covers, or a
            # retried chunk would be linked twice
            snap["attest"] = eng.attest.snapshot()
        return snap

    def _rollback(self, snap: dict) -> None:
        """Give the engine back the state before the failed attempt; its
        host caches (step numbers, live flags, fault schedule) are
        re-derived from it at the next chunk."""
        eng = self.engine
        eng.state = snap["state"]
        eng.steps_run = snap["steps_run"]
        eng.cycle_base = snap["cycle_base"]
        eng.host_counters = snap["host_counters"]
        if self.kind == "stream":
            eng.cursor = snap["cursor"]
            eng.window_chunks = snap["window_chunks"]
        if "attest" in snap and getattr(eng, "attest", None) is not None:
            eng.attest.restore(snap["attest"])
        eng._stepped = None

    def _chaos_revoke_check(self) -> None:
        """Chaos `capacity_loss` site at a chunk boundary: a revocation
        takes `min(n, len(pool) - 1)` devices, always leaving one. The
        port's pool is the engine's one card, so that is 0 and nothing is
        lost; the site's arrival is still counted and a fired event
        logged, as on a one-device JAX backend."""
        chaos_sites.device_revoke("devices.revoke")

    def _advance_chunk(self, budget_left: int) -> int:
        """Advance the engine by one committed chunk; returns steps run
        (a stream: the window's device loop's count)."""
        self._chaos_revoke_check()
        if self.kind == "stream":
            k, finished = self.engine._advance_window(budget_left)
            self._stream_finished = finished
            return k
        before = self._steps_used()
        self.engine.run_steps(self.engine.chunk_steps)
        return self._steps_used() - before

    # ---- retry / degradation --------------------------------------------

    def _advance_with_retry(self, budget_left: int) -> int:
        from ..util.backoff import DecorrelatedJitter

        attempt = 0
        # decorrelated jitter: a fault front that knocks over N supervised
        # runs at once must not produce N phase-locked retry storms
        backoff = DecorrelatedJitter(base=self.backoff_s, cap=30.0)
        while True:
            snap = self._snapshot()
            try:
                return self._advance_chunk(budget_left)
            except Exception as e:
                self._rollback(snap)
                kind = classify_failure(e)
                if kind is None:
                    raise
                if kind == "device_loss":
                    # one device and no reshard ladder: nothing to demote,
                    # so the bounded backoff-retry path below
                    kind = "transient"
                if attempt >= self.max_retries:
                    self._log(
                        "give-up",
                        f"{kind} failure persisted after "
                        f"{self.max_retries} retries: {e}",
                    )
                    raise
                attempt += 1
                self.retries += 1
                chunk = getattr(self.engine, "chunk_steps", 1)
                if kind == "oom" and chunk > 1:
                    # halving only changes the drain/rebase cadence
                    self.engine.chunk_steps = max(1, chunk // 2)
                    at = getattr(self.engine, "attest", None)
                    if at is not None:
                        # the chain is cadence-scoped (§24): record the
                        # halving so it reads as incomparable, never as a
                        # false divergence
                        at.note_cadence(self.engine.chunk_steps)
                    self._log(
                        "degrade",
                        f"device OOM: chunk_steps {chunk} -> "
                        f"{self.engine.chunk_steps}, retrying "
                        f"(attempt {attempt}/{self.max_retries})",
                    )
                else:
                    delay = backoff.next_delay()
                    self._log(
                        "retry",
                        f"transient failure ({e}); backing off "
                        f"{delay:.2f}s (attempt {attempt}/"
                        f"{self.max_retries})",
                    )
                    time.sleep(delay)

    # ---- chaos mode -----------------------------------------------------

    _CHAOS_KEYS = ("core_failstops", "noc_reroutes", "ecc_corrected",
                   "ecc_due")

    def _chaos_check(self) -> None:
        """Log fault-counter movement since the last committed chunk."""
        if not self._chaos:
            return
        hc = self.engine.host_counters
        cur = {
            k: int(np.asarray(hc[k]).sum()) for k in self._CHAOS_KEYS if k in hc
        }
        moved = [
            f"{k} +{v - self._fault_seen.get(k, 0)} (total {v})"
            for k, v in cur.items()
            if v > self._fault_seen.get(k, 0)
        ]
        if moved:
            self._log("chaos", "; ".join(moved))
        self._fault_seen = cur

    # ---- guard ----------------------------------------------------------

    def _guard_check(self) -> None:
        if self.guard == "off":
            return
        totals = self._counter_totals()
        try:
            if self.kind == "fleet":
                core_done = self.engine.core_done_mask()
                live = self.engine.live_mask()
                host = _host_state(self.engine.state)
                for i, cfg in enumerate(self.engine.elem_cfgs):
                    check_chunk_invariants(
                        cfg, map_state(lambda x, i=i: x[i], host),
                        done_mask=core_done[i], live_mask=live[i],
                    )
                check_chunk_invariants(
                    self.engine.cfg, None,
                    prev_totals=self._prev_totals, totals=totals,
                )
            else:
                check_chunk_invariants(
                    self.engine.cfg,
                    _host_state(self.engine.state),
                    done_mask=self.engine.done_mask(),
                    live_mask=self.engine.live_mask(),
                    prev_totals=self._prev_totals,
                    totals=totals,
                )
        except AssertionError as e:
            if self.guard == "warn":
                self.guard_warnings += 1
                self._log("guard-warn", str(e))
            else:
                self._log("guard-fail", str(e))
                raise GuardViolation(str(e)) from e
        self._prev_totals = totals

    # ---- the supervised loop --------------------------------------------

    def run(self, max_steps: int | None = None) -> None:
        """Run the engine to completion under supervision.

        Raises Preempted (after checkpointing) on SIGTERM/SIGINT,
        GuardViolation under `guard="fail"`, RuntimeError when the step
        budget runs out with cores still live (fleet: budget-stalled
        elements are recorded in `stalled_elements` instead). A stream's
        budget defaults to its engine's `_default_budget`."""
        if max_steps is None:
            max_steps = (
                self.engine._default_budget()
                if self.kind == "stream"
                else 10_000_000
            )
        budget_left = int(max_steps)
        start_steps = self._steps_used()
        self._install_signals()
        self._prev_totals = self._counter_totals()
        if self._chaos:
            cfg = self.engine.cfg
            self._log(
                "chaos",
                f"fault injection armed: seed {cfg.fault_seed}, "
                f"{len(cfg.fault_events)} scheduled event(s), "
                f"dead policy {cfg.fault_dead_policy}",
            )
            self._fault_seen = {
                k: int(np.asarray(self.engine.host_counters[k]).sum())
                for k in self._CHAOS_KEYS
                if k in self.engine.host_counters
            }
        last_ckpt_t = time.monotonic()
        chunks_since_ckpt = 0
        try:
            while not self._done():
                if self.kind == "stream":
                    stepped = self._advance_with_retry(budget_left)
                    budget_left -= stepped
                else:
                    stepped = self._advance_with_retry(0)
                self.committed += 1
                chunks_since_ckpt += 1
                if self.on_chunk is not None:
                    self.on_chunk(self)
                self._chaos_check()
                self._guard_check()
                if self._preempt is not None:
                    signum = self._preempt
                    path = self.checkpoint()
                    name = signal.Signals(signum).name
                    where = (
                        f"snapshot {os.path.basename(path)}"
                        if path
                        else "no snapshot dir configured"
                    )
                    self._log("preempt", f"{name} at chunk boundary; {where}")
                    raise Preempted(
                        f"preempted by {name} after {self.committed} "
                        f"committed chunks ({where})",
                        checkpoint=path,
                        signum=signum,
                    )
                now = time.monotonic()
                if self.store is not None and (
                    (
                        self.checkpoint_every_chunks > 0
                        and chunks_since_ckpt >= self.checkpoint_every_chunks
                    )
                    or (
                        self.checkpoint_every_s > 0
                        and now - last_ckpt_t >= self.checkpoint_every_s
                    )
                ):
                    self.checkpoint()
                    chunks_since_ckpt = 0
                    last_ckpt_t = now
                if self.kind != "stream":
                    if stepped == 0 or (
                        self._steps_used() - start_steps >= max_steps
                        and not self._done()
                    ):
                        if self.kind == "fleet":
                            self.stalled_elements = [
                                self.engine.element_ids[j]
                                for j in np.flatnonzero(~self.engine.done_mask())
                            ]
                            self._log(
                                "stall",
                                f"step budget exhausted; elements "
                                f"{self.stalled_elements} still live — "
                                "isolating, rest of the batch is complete",
                            )
                            break
                        raise RuntimeError(
                            f"supervised run: step budget ({max_steps}) "
                            "exhausted with cores still live (deadlock?)"
                        )
                elif budget_left <= 0 and not self._done():
                    raise RuntimeError(
                        f"supervised run: step budget ({max_steps}) "
                        "exhausted with the stream unfinished"
                    )
            if self.store is not None:
                self.checkpoint()  # final snapshot: resume == no-op rerun
        finally:
            self._restore_signals()


# ---- fleet fault isolation (pre-run) ------------------------------------


def validate_fleet_element(cfg, trace, override: dict | None = None) -> None:
    """Everything FleetEngine.__init__ would reject about ONE element,
    checked in isolation: override keys/values, core count, addressing
    line size, barrier ids vs the slot table. Raises ValueError (often
    the located TraceError subclass)."""
    from .fleet import apply_overrides

    apply_overrides(cfg, override or {})
    if trace.n_cores != cfg.n_cores:
        raise ValueError(f"trace has {trace.n_cores} cores, config {cfg.n_cores}")
    if trace.line_addressed:
        trace.line_events(cfg.line_bits)  # line-size validation only
    validate_sync(trace, cfg.barrier_slots)


def build_fleet_isolated(
    cfg,
    sources: list,
    overrides: list[dict] | None = None,
    chunk_steps: int = 256,
    device=None,
):
    """Build a FleetEngine from per-element sources with fault isolation.

    `sources[i]` is a Trace or a zero-arg callable returning one (pass
    callables for file loads so an unreadable/corrupt FILE quarantines
    its element instead of killing the batch). Elements whose load or
    validation fails are dropped; the survivors' batch positions map
    back to caller indices through `fleet.element_ids`.

    Returns `(fleet, quarantined)` where `quarantined` is a list of
    `(original_index, exception)` and `fleet` is None when nothing
    survived."""
    from .fleet import FleetEngine

    sources = list(sources)
    if overrides is None:
        overrides = [{}] * len(sources)
    overrides = list(overrides)
    if len(overrides) != len(sources):
        raise ValueError(
            f"got {len(sources)} trace sources but {len(overrides)} "
            "override dicts (must match 1:1)"
        )
    kept, kept_ovs, ids = [], [], []
    quarantined: list[tuple[int, Exception]] = []
    for i, (src, ov) in enumerate(zip(sources, overrides)):
        try:
            trace = src() if callable(src) else src
            validate_fleet_element(cfg, trace, ov)
        except (ValueError, OSError) as e:
            quarantined.append((i, e))
            continue
        kept.append(trace)
        kept_ovs.append(ov)
        ids.append(i)
    if not kept:
        return None, quarantined
    fleet = FleetEngine(cfg, kept, kept_ovs, chunk_steps=chunk_steps, device=device)
    fleet.element_ids = ids
    return fleet, quarantined
