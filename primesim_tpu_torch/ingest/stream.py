"""Windowed (streaming) trace ingest: the JAX package's
`ingest/stream.py` for the port.

The host holds per-core cursors into the (possibly memory-mapped) event
source and uploads one `window_events`-deep window of every core's
stream at a time, [C, W + 1, 4] int32, END-padded; the window's device
loop (`sim/engine.py::stream_loop`) steps until some core that has
events beyond its window runs low, at the step where the JAX package's
`stream_loop` leaves its `while_loop`. So a streamed run is bit-exact
with a preloaded `Engine.run()`, LRU stamps included, and it makes the
JAX `StreamEngine`'s window cuts: at each cut the cursors and every
state field equal JAX's, which is what lets a stream snapshot move
between the two packages.

Device memory holds the machine state and one window, O(C * W), not the
[C, T, 4] trace a preloaded run uploads; host memory is O(C * W) beyond
a memory-mapped file. A byte-addressed trace is line-normalised window
by window, so a memory-mapped source is never copied whole.

    from primesim_tpu_torch.ingest.stream import StreamEngine
    eng = StreamEngine(cfg, Trace.load("huge.ptpu", mmap=True),
                       window_events=4096)
    eng.run()

Fault injection is refused: the JAX package's CLI refuses it with
`--stream-window` (its window prefetcher cannot know that a core died
mid-window), and the port's engine refuses it with the same text.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config.machine import MachineConfig, check_port_supported
from ..kernels import build
from ..sim.engine import _ACC_BITS, group_tables, resolve_device, stream_loop
from ..sim.state import init_state
from ..stats.counters import COUNTER_NAMES, zero_counters
from ..trace.format import (
    EV_BARRIER,
    EV_END,
    EV_LD,
    EV_LOCK,
    EV_ST,
    EV_UNLOCK,
    Trace,
    TraceError,
    scan_trace_meta,
)

# the JAX package's refusal of faults with --stream-window, word for word
FAULTS_REFUSED = (
    "fault injection does not compose with --stream-window yet "
    "(window rebasing assumes the fault-free retirement order)"
)


def absorb_stream_outputs(eng, out, buf):
    """Fold one window's `stream_loop` output (`sim.engine.WindowOut`)
    into a streaming engine's host accumulators: the int64 counters, the
    cycle base, the steps and the cursors. The one implementation of the
    drain protocol, shared by StreamEngine and the ring-fed OnlineEngine.
    Returns (steps executed, events consumed per core, at-END mask)."""
    for i, name in enumerate(COUNTER_NAMES):
        eng.host_counters[name] += out.counters[i]
    eng.cycle_base += out.base
    eng.steps_run += out.steps
    eng.state = out.state  # ptr: the window-relative events consumed
    consumed = out.ptr
    at_end = buf[np.arange(eng.cfg.n_cores), np.minimum(consumed, eng.W), 0] == EV_END
    eng.cursor += consumed
    eng.window_chunks.append(out.chunks)
    return out.steps, consumed, at_end


def warm_kernels(cfg: MachineConfig, device: torch.device) -> None:
    """Build and load every kernel on the card, and upload a coarse
    vector's group tables, before a timed region (no step runs)."""
    if device.type == "cuda":
        build.libraries(build.KERNELS)
    if cfg.sharer_group > 1:  # keyed by the device as the step names it (cuda:0)
        group_tables(cfg, torch.empty(0, device=device).device)


class StreamEngine:
    """Bounded-memory streaming runner, bit-exact with `Engine.run`, on
    `cuda` unless `device` names another device."""

    def __init__(self, cfg: MachineConfig, trace: Trace, window_events: int = 1024,
                 device=None):
        check_port_supported(cfg)
        self.device = resolve_device(device)
        if cfg.faults_enabled:
            raise ValueError(FAULTS_REFUSED)
        if trace.n_cores != cfg.n_cores:
            raise ValueError(
                f"trace has {trace.n_cores} cores but config has {cfg.n_cores}"
            )
        if window_events < max(1, cfg.local_run_len + 1):
            raise ValueError(
                "window_events must cover at least one local run + 1 event"
            )
        self.cfg = cfg
        self.trace = trace
        # the raw (possibly memory-mapped) source; a line-addressed trace
        # only has its recorded line size checked
        if trace.line_addressed:
            trace.line_events(cfg.line_bits)
        self.src = trace.events
        # one bounded-memory pass over the source: sync presence, the
        # largest instruction batch of an event and the barrier ids
        self.has_sync, per_ev, bad_bid = scan_trace_meta(trace, cfg.barrier_slots)
        if bad_bid:
            raise TraceError(
                f"trace uses barrier ids >= barrier_slots={cfg.barrier_slots}",
                core=bad_bid[0],
                offset=bad_bid[1],
            )
        self.real_len = np.asarray(trace.lengths, dtype=np.int64) - 1  # pre-END events
        self.cursor = np.zeros(cfg.n_cores, dtype=np.int64)
        self.W = int(window_events)
        # the counters drain at least every 64 steps of a window
        if 64 * (cfg.local_run_len + 1) * per_ev >= 1 << _ACC_BITS:
            raise ValueError(
                "trace's max per-event instruction batch overflows the "
                "streaming 64-step counter drain; split INS batches"
            )
        self.state = init_state(cfg, self.device)
        self.cycle_base = 0
        self.host_counters = zero_counters(cfg.n_cores)
        self.steps_run = 0
        self.window_chunks: list[int] = []  # host transfers of each window
        # telemetry sink (obs.Recorder): None records nothing
        self.obs = None
        self.obs_label = "stream"
        # attestation chain (attest.SoloAttest), window-scoped: the stream
        # engine's natural chunk is the window, observed once after it is
        # absorbed (never per host chunk), with the cursors in the digest;
        # None hashes nothing
        self.attest = None

    def _fill_window(self):
        """The next window of every core's stream from the cursors: the
        [C, W + 1, 4] int32 buffer (END-padded, line-normalised), the
        [C] exhausted mask and the [C] real events buffered. One gather
        over the cursors; a memory-mapped source faults in only the pages
        it touches."""
        C = self.cfg.n_cores
        buf = np.zeros((C, self.W + 1, 4), dtype=np.int32)
        buf[:, :, 0] = EV_END
        take = np.maximum(np.minimum(self.W, self.real_len - self.cursor), 0)
        idx = self.cursor[:, None] + np.arange(self.W, dtype=np.int64)[None, :]
        valid = idx < (self.cursor + take)[:, None]
        idx = np.minimum(idx, self.src.shape[1] - 1)
        vals = np.take_along_axis(self.src, idx[:, :, None], axis=1)  # [C, W, 4]
        buf[:, : self.W] = np.where(valid[:, :, None], vals, buf[:, : self.W])
        filled = take.astype(np.int32)
        exhausted = self.cursor + take >= self.real_len
        if not self.trace.line_addressed:
            t = buf[:, :, 0]
            addr_ev = (t == EV_LD) | (t == EV_ST) | (t == EV_LOCK) | (t == EV_UNLOCK)
            buf[:, :, 2] = np.where(addr_ev, buf[:, :, 2] >> self.cfg.line_bits, buf[:, :, 2])
        return buf, exhausted, filled

    def warmup(self) -> None:
        """Build and load the kernels (and a coarse vector's tables) and
        run no step: called before a timed region, as the JAX package's
        warmup compiles its loop."""
        warm_kernels(self.cfg, self.device)

    def _advance_window(self, budget: int) -> tuple[int, bool]:
        """Fill, upload and run ONE window, then drain it into the host's
        accumulators and advance the cursors. Returns (steps executed,
        finished). After it returns the engine is at a consistent cut
        (cursors and state describe the run), where a stream snapshot
        can be taken."""
        cfg = self.cfg
        t0 = time.perf_counter()
        buf, exhausted, filled = self._fill_window()
        t1 = time.perf_counter()
        events = torch.from_numpy(buf).to(self.device)
        st = self.state._replace(
            ptr=torch.zeros(cfg.n_cores, dtype=torch.int32, device=self.device))
        out = stream_loop(cfg, events, st, exhausted, filled,
                          min(budget, 2**31 - 1), self.has_sync)
        t2 = time.perf_counter()
        k, consumed, at_end = absorb_stream_outputs(self, out, buf)
        if self.obs is not None:
            # one sample per WINDOW, the stream engine's natural chunk;
            # the chunks' transfers synchronise, so dispatch holds the
            # device's work
            t3 = time.perf_counter()
            self.obs.chunk_committed(
                self.obs_label, k, t3 - t0, self.host_counters,
                phases={"fill": t1 - t0, "dispatch": t2 - t1, "absorb": t3 - t2},
            )
        if self.attest is not None:
            self.attest.observe(self)
        finished = bool((at_end & exhausted).all())
        if not finished and k == 0 and not consumed.any():
            raise RuntimeError(
                "stream engine: no progress in a window (window_events "
                "too small for this trace shape?)"
            )
        return k, finished

    def _default_budget(self) -> int:
        return max(10_000_000, 64 * int(self.real_len.sum()))

    def done(self) -> bool:
        """All cores consumed their real (pre-END) events."""
        return bool((self.cursor >= self.real_len).all())

    def done_mask(self) -> np.ndarray:
        """Per-core finished mask, from the stream cursors."""
        return self.cursor >= self.real_len

    def live_mask(self) -> np.ndarray:
        """Cores that bound the quantum window at this cut: not finished
        and not frozen at a barrier. The supervisor's guard reads it, as
        it reads `Engine.live_mask`, here from the cursors into the
        source."""
        C = self.cfg.n_cores
        at = np.minimum(self.cursor, np.maximum(self.real_len - 1, 0))
        et = np.asarray(self.src[np.arange(C), at, 0])
        frozen = (et == EV_BARRIER) & (self.state.sync_flag.cpu().numpy() != 0)
        return (self.cursor < self.real_len) & ~frozen

    def run(self, max_steps: int | None = None) -> None:
        """Stream to completion. `max_steps` defaults to a budget from the
        trace's event count (`_default_budget`)."""
        budget = max_steps if max_steps is not None else self._default_budget()
        while True:
            k, finished = self._advance_window(budget)
            budget -= k
            if finished:
                return
            if budget <= 0:
                raise RuntimeError(
                    f"stream engine: step budget ({max_steps}) exhausted at "
                    f"{int(self.cursor.sum())}/{int(self.real_len.sum())} "
                    "events consumed — deadlocked barrier/lock, or pass a "
                    "larger max_steps"
                )

    def run_events(self, target_events: int) -> bool:
        """Advance window by window until at least `target_events` events
        are consumed in all (or the stream finishes): the pause point of
        a stream snapshot. Returns finished."""
        budget = self._default_budget()
        while int(self.cursor.sum()) < target_events:
            k, finished = self._advance_window(budget)
            budget -= k
            if finished:
                return True
            if budget <= 0:
                raise RuntimeError("stream engine: step budget exhausted")
        return False

    def save_checkpoint(self, path: str) -> None:
        from ..sim.checkpoint import save_stream_checkpoint

        save_stream_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> None:
        from ..sim.checkpoint import load_stream_checkpoint

        load_stream_checkpoint(path, self)

    @property
    def cycles(self) -> np.ndarray:
        return self.state.cycles.cpu().numpy().astype(np.int64) + self.cycle_base

    @property
    def counters(self) -> dict[str, np.ndarray]:
        return self.host_counters
