"""MPMD-pipelined streaming ingest — the rung-5 end-to-end path
(DESIGN.md §22, PAPERS.md: MPMD pipeline parallelism): the JAX package's
`ingest/pipeline.py` for the port.

At 16384 cores the streaming engine's wall-clock splits into two serial
stages: the HOST window fill (gather + line-normalize O(C*W) events per
window) and the DEVICE window simulation. This module pipelines them
MPMD-style over the existing pool lease protocol:

- stage 1 (ingest): the trace is cut into fixed-size SEGMENTS — segment k
  holds every core's events [k*L, (k+1)*L) — and each segment is one pool
  work unit (`pool.units.build_ingest_units`). Worker processes
  materialize segments concurrently (line-normalized, END-padded) into
  atomic npz files under `<pool_dir>/segments/`, ahead of the simulation.
  The workers are `python -m primesim_tpu_torch worker` processes;
  ingest is host work, so they never touch the card.
- stage 2 (sim): `PipelineStreamEngine` — a `StreamEngine` whose window
  fill assembles the (simulation-dependent, per-core-cursor) dynamic
  window from resident segments instead of re-reading and re-normalizing
  the raw source. It blocks only when the ingest stage has not yet
  produced a segment the cursors need.
- stage 3 (stats): unchanged — the engine's host accumulators fold
  downstream exactly as for any streaming run, so checkpoints/resume and
  the supervisor contract are untouched.

Segment boundaries are trace-indexed (not simulation-dependent), which is
what makes stage 1 embarrassingly parallel and restartable: segments are
mutually independent units, so lease expiry, hedging, and poison verdicts
apply unchanged, and a resumed run re-uses every segment already on disk.

Bit-exactness: segments carry the SAME line-normalized event values the
plain `StreamEngine._fill_window` would produce, so the assembled window
is byte-identical and the simulated results are bit-exact vs both the
plain stream engine and a preloaded `Engine.run()`.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..trace.format import EV_END, Trace
from .stream import StreamEngine


def normalize_segment(cfg, trace: Trace, seg_index: int,
                      seg_events: int) -> tuple[np.ndarray, int]:
    """Materialize segment `seg_index` of `trace`: every core's events
    [k*L, (k+1)*L), line-normalized for `cfg`, END-padded past each
    core's real (pre-END) length. Returns (events [C, L, 4] int32,
    n_valid). Pure and deterministic — any worker produces identical
    bytes for the same unit."""
    from ..trace.format import EV_LD, EV_LOCK, EV_ST, EV_UNLOCK

    C = cfg.n_cores
    if trace.n_cores != C:
        raise ValueError(f"trace has {trace.n_cores} cores, config {C}")
    if trace.line_addressed:
        trace.line_events(cfg.line_bits)  # line-size validation only
    L = int(seg_events)
    start = int(seg_index) * L
    src = trace.events
    real_len = np.asarray(trace.lengths, dtype=np.int64) - 1
    arr = np.zeros((C, L, 4), dtype=np.int32)
    arr[:, :, 0] = EV_END
    stop = min(start + L, src.shape[1])
    if stop > start:
        n = stop - start
        # memmap sources fault in only this segment's pages
        vals = np.asarray(src[:, start:stop], dtype=np.int32)
        idx = start + np.arange(n, dtype=np.int64)
        valid = idx[None, :] < real_len[:, None]
        arr[:, :n] = np.where(valid[:, :, None], vals, arr[:, :n])
    if not trace.line_addressed:
        t = arr[:, :, 0]
        addr_ev = (
            (t == EV_LD) | (t == EV_ST) | (t == EV_LOCK) | (t == EV_UNLOCK)
        )
        arr[:, :, 2] = np.where(
            addr_ev, arr[:, :, 2] >> cfg.line_bits, arr[:, :, 2]
        )
    n_valid = int(
        np.minimum(np.maximum(real_len - start, 0), L).sum()
    )
    return arr, n_valid


def segment_path(pool_dir: str, seg_index: int) -> str:
    return os.path.join(
        str(pool_dir), "segments", f"seg-{int(seg_index):05d}.npz"
    )


def write_segment(path: str, seg_index: int, seg_events: int,
                  events: np.ndarray) -> None:
    """Atomic (tmp+rename, CRC-manifested) segment write — a reader never
    sees a torn segment, and hedged ingest twins writing the same path
    are both complete snapshots of identical bytes."""
    from ..sim.checkpoint import atomic_save_npz

    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_save_npz(
        path,
        seg_index=np.int64(seg_index),
        seg_events=np.int64(seg_events),
        events=np.asarray(events, np.int32),
    )


def read_segment(path: str, seg_index: int, seg_events: int) -> np.ndarray:
    """CRC-verified segment read, validated against the expected slot
    (a mis-addressed or stale file must not silently feed the sim)."""
    from ..sim.checkpoint import load_verified_npz

    z = load_verified_npz(path)
    if int(z["seg_index"]) != int(seg_index) or int(
        z["seg_events"]
    ) != int(seg_events):
        raise ValueError(
            f"{path}: segment identity mismatch (got seg "
            f"{int(z['seg_index'])}/L={int(z['seg_events'])}, expected "
            f"{int(seg_index)}/L={int(seg_events)})"
        )
    return z["events"]


class SegmentSpool:
    """Host-side cache of resident ingest segments for one run.

    `acquire(lo, hi)` returns {seg_index: events} for every segment in
    [lo, hi], blocking (with `wait_cb` ticks — `run_pipelined` pumps the
    coordinator's lease expiry there) until the ingest stage has
    produced the missing ones. `evict_below(k)` drops segments the
    cursors have fully passed, bounding residency to the cursor spread
    plus one window."""

    def __init__(self, pool_dir: str, seg_events: int, n_segments: int,
                 wait_cb=None, poll_s: float = 0.05,
                 timeout_s: float = 600.0):
        self.pool_dir = str(pool_dir)
        self.seg_events = int(seg_events)
        self.n_segments = int(n_segments)
        self.wait_cb = wait_cb
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self._resident: dict[int, np.ndarray] = {}
        self.waits = 0  # pipeline stalls (sim outran ingest)

    def _try_load(self, k: int) -> bool:
        from ..sim.checkpoint import CheckpointCorrupt

        try:
            self._resident[k] = read_segment(
                segment_path(self.pool_dir, k), k, self.seg_events
            )
            return True
        except (FileNotFoundError, CheckpointCorrupt):
            return False  # not produced yet (or mid-rewrite); keep polling

    def acquire(self, lo: int, hi: int) -> dict[int, np.ndarray]:
        lo = max(0, int(lo))
        hi = min(int(hi), self.n_segments - 1)
        missing = [
            k for k in range(lo, hi + 1) if k not in self._resident
        ]
        deadline = time.monotonic() + self.timeout_s
        stalled = False
        while missing:
            missing = [k for k in missing if not self._try_load(k)]
            if not missing:
                break
            if not stalled:
                stalled = True
                self.waits += 1
            if self.wait_cb is not None:
                self.wait_cb()
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"ingest pipeline stalled: segment(s) {missing} not "
                    f"produced within {self.timeout_s:.0f}s (ingest "
                    "workers dead and leases unrecoverable?)"
                )
            time.sleep(self.poll_s)
        return {k: self._resident[k] for k in range(lo, hi + 1)}

    def evict_below(self, k: int) -> None:
        for j in [j for j in self._resident if j < k]:
            del self._resident[j]


class PipelineStreamEngine(StreamEngine):
    """StreamEngine fed by the ingest stage: the window fill gathers from
    resident (pre-normalized) segments instead of the raw source. The
    device loop, drain protocol, checkpoint format, and supervisor
    contract are all inherited unchanged — only where the window's bytes
    come from differs, and those bytes are identical."""

    def __init__(self, cfg, trace: Trace, spool: SegmentSpool,
                 window_events: int = 1024, device=None, mesh=None):
        if window_events > spool.seg_events:
            raise ValueError(
                f"window_events={window_events} exceeds the ingest "
                f"segment size {spool.seg_events}; a window must span at "
                "most two segments"
            )
        super().__init__(cfg, trace, window_events=window_events,
                         device=device, mesh=mesh)
        self.spool = spool

    def _fill_window(self):
        C = self.cfg.n_cores
        L = self.spool.seg_events
        buf = np.zeros((C, self.W + 1, 4), dtype=np.int32)
        buf[:, :, 0] = EV_END
        take = np.minimum(self.W, self.real_len - self.cursor)
        take = np.maximum(take, 0)
        filled = take.astype(np.int32)
        exhausted = self.cursor + take >= self.real_len
        live = take > 0
        if live.any():
            lo = int(self.cursor[live].min()) // L
            hi = int((self.cursor + take - 1)[live].max()) // L
            segs = self.spool.acquire(lo, hi)
            arr = np.concatenate(
                [segs[j] for j in range(lo, hi + 1)], axis=1
            )
            idx = (
                self.cursor[:, None]
                + np.arange(self.W, dtype=np.int64)[None, :]
                - lo * L
            )
            valid = np.arange(self.W)[None, :] < take[:, None]
            idx = np.clip(idx, 0, arr.shape[1] - 1)
            vals = np.take_along_axis(arr, idx[:, :, None], axis=1)
            buf[:, : self.W] = np.where(
                valid[:, :, None], vals, buf[:, : self.W]
            )
            self.spool.evict_below(int(self.cursor.min()) // L)
        return buf, exhausted, filled


def _spawn_ingest_worker(socket_path: str, worker_id: str):
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "primesim_tpu_torch", "worker",
        "--connect", socket_path,
        "--worker-id", worker_id,
    ]
    # stdout is the run's JSON surface — workers must not write to it
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL)


def run_pipelined(
    cfg,
    trace: Trace,
    *,
    trace_path: str | None = None,
    synth_spec: str | None = None,
    window_events: int = 1024,
    seg_events: int | None = None,
    ingest_workers: int = 2,
    pool_dir: str | None = None,
    device=None,
    mesh=None,
    lease_ttl_s: float = 10.0,
    supervisor_kwargs: dict | None = None,
    max_steps: int | None = None,
    resume: bool = False,
    obs=None,
    log=None,
):
    """Drive one pipelined streaming run end-to-end: in-process pool
    coordinator over the ingest units, `ingest_workers` worker
    subprocesses, and a supervised `PipelineStreamEngine` in THIS process
    (checkpoints/resume work exactly as for any supervised stream run —
    plus segments persist under `pool_dir`, so a resumed run re-uses
    every segment already ingested). The engine is made, and its device
    resolved (the card unless `device` names another; no card raises;
    on `mesh`, its lead device) and its kernels loaded, before any
    worker is spawned. Ingest units stay host-only on a mesh too: only
    the engine is sharded. Returns (engine, supervisor, ingest_stats)."""
    import shutil
    import tempfile

    from ..pool.coordinator import PoolCoordinator
    from ..pool.units import DONE, build_ingest_units
    from ..sim.supervisor import RunSupervisor

    if (trace_path is None) == (synth_spec is None):
        raise ValueError(
            "run_pipelined needs exactly one of trace_path/synth_spec "
            "(the portable source spec ingest workers materialize)"
        )
    L = int(seg_events) if seg_events else max(int(window_events), 4096)
    real_max = int(
        (np.asarray(trace.lengths, dtype=np.int64) - 1).max(initial=0)
    )
    n_segments = max(1, -(-real_max // L))
    units = build_ingest_units(
        cfg, trace_path, synth_spec, L, n_segments
    )
    ephemeral = pool_dir is None
    pool_dir = pool_dir or tempfile.mkdtemp(prefix="primetpu-ingest-")
    coord = PoolCoordinator(
        units, pool_dir, lease_ttl_s=lease_ttl_s, obs=obs
    )
    pre_done = sum(
        1 for u in coord.units.values() if u["state"] == DONE
    )
    coord.start()
    workers: list = []

    def _pump():
        coord.tick()
        if not coord.done and all(w.poll() is not None for w in workers):
            # liveness: the sim must not wait forever on a dead stage
            workers.append(
                _spawn_ingest_worker(
                    coord.socket_path, f"ing{len(workers)}"
                )
            )

    spool = SegmentSpool(
        pool_dir, L, n_segments, wait_cb=_pump,
        timeout_s=max(600.0, 60.0 * lease_ttl_s),
    )
    try:
        eng = PipelineStreamEngine(
            cfg, trace, spool, window_events=int(window_events),
            device=device, mesh=mesh,
        )
        eng.warmup()  # the kernels load before the first window
        if log:
            log(
                f"ingest pipeline: {n_segments} segment(s) of {L} "
                f"events/core ({pre_done} already ingested), "
                f"{ingest_workers} worker(s) on {coord.socket_path}"
            )
        workers += [
            _spawn_ingest_worker(coord.socket_path, f"ing{k}")
            for k in range(int(ingest_workers))
        ]
        if obs is not None and hasattr(obs, "attach"):
            obs.attach(eng)
        sup = RunSupervisor(eng, **(supervisor_kwargs or {}))
        if resume:
            sup.resume()
        try:
            sup.run(
                max_steps=(
                    max_steps if max_steps else eng._default_budget()
                )
            )
        except Exception as e:
            # callers (the CLI's preemption path) need the supervisor's
            # summary even when the run stops early
            e.supervisor = sup
            raise
        ingest_stats = {
            "segments": n_segments,
            "seg_events": L,
            "segments_preingested": pre_done,
            "pipeline_stalls": spool.waits,
            "pool": coord.pool_report(),
        }
        return eng, sup, ingest_stats
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        coord.close(drained=coord.done)
        if ephemeral:
            shutil.rmtree(pool_dir, ignore_errors=True)
