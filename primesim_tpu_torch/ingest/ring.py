"""Online execution-driven ingest: the JAX package's `ingest/ring.py` for
the port. The capture shim (`frontend/ptpu_capture.cpp`, its
PTPU_RING_OUT mode) streams events into per-thread single-producer
rings inside one mmap'd file, and `OnlineEngine` simulates them WHILE
the target program runs.

The host drains the rings EAGERLY into unbounded per-core host buffers,
so a producer thread never waits on the simulation, only on the host's
drain cadence: a bounded ring and an unbounded host queue cannot
deadlock against the target's own pthread dependencies.

`OnlineEngine` runs the same window loop as `StreamEngine`
(`sim/engine.py::stream_loop`, folded by `stream.absorb_stream_outputs`),
one `window_events`-deep window per core on the device, refilled as the
host buffers grow. So its results equal a preloaded run of the same
captured stream, bit for bit (`RingSource.to_trace()` gives that stream
back as a Trace). A core counts as exhausted only when the shim had
marked it DONE before the drain that filled its window.
"""

from __future__ import annotations

import mmap
import os
import time

import numpy as np
import torch

from ..config.machine import MachineConfig, check_port_supported
from ..sim.engine import _ACC_BITS, resolve_device, stream_loop
from ..sim.state import init_state
from ..stats.counters import zero_counters
from ..trace.format import EV_BARRIER, EV_END, N_FIELDS, Trace
from .stream import FAULTS_REFUSED, absorb_stream_outputs, warm_kernels

RING_MAGIC = 0x50525247  # 'PRRG'
RSTATE_UNUSED, RSTATE_ACTIVE, RSTATE_DONE = 0, 1, 2

_HDR_WORDS = 16  # 64-byte header, u32 words
_CTL_WORDS = 16  # 64-byte control block per ring, u32 words


class RingSource:
    """Reader side of the capture shim's mmap'd ring file.

    `drain()` moves every newly published record into per-core host
    buffers and releases the ring slots (advancing `ridx` AFTER the copy
    — the producer's release-store on `widx` orders its data writes, and
    x86 load ordering makes the acquire side implicit).
    """

    def __init__(
        self,
        path: str,
        n_cores: int,
        timeout_s: float = 30.0,
        unlink_on_close: bool = False,
        retain_history: bool = False,
    ):
        self._unlink = unlink_on_close
        self._path = path
        self.retain_history = retain_history
        t0 = time.monotonic()
        # the shim creates+sizes the file at target launch; wait for the
        # release-published magic
        while True:
            try:
                if os.path.getsize(path) >= 64:
                    self._f = open(path, "r+b")
                    self._mm = mmap.mmap(self._f.fileno(), 0)
                    # plain byte read for the probe — a numpy view would
                    # pin the mmap (BufferError on close) if we must retry
                    if int.from_bytes(self._mm[:4], "little") == RING_MAGIC:
                        break
                    self._mm.close()
                    self._f.close()
            except OSError:
                pass
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"ring file {path} never initialized")
            time.sleep(0.005)
        hdr = np.frombuffer(self._mm, np.uint32, _HDR_WORDS, 0)
        self.version = int(hdr[1])
        self.max_cores = int(hdr[2])
        self.records = int(hdr[3])
        self.line = int(hdr[4])
        self.flags = int(hdr[5])
        self.line_bits = (self.flags >> 8) & 0xFF
        if n_cores > self.max_cores:
            raise ValueError(
                f"ring has {self.max_cores} slots but {n_cores} cores asked"
            )
        self.n_cores = n_cores
        ctl_off = _HDR_WORDS * 4
        self._ctl64 = np.frombuffer(
            self._mm, np.uint64, self.max_cores * 8, ctl_off
        ).reshape(self.max_cores, 8)  # [widx, ridx, state|pad, dropped, ...]
        self._ctl32 = np.frombuffer(
            self._mm, np.uint32, self.max_cores * _CTL_WORDS,
            ctl_off,
        ).reshape(self.max_cores, _CTL_WORDS)
        data_off = ctl_off + self.max_cores * _CTL_WORDS * 4
        self._data = np.frombuffer(
            self._mm, np.int32, self.max_cores * self.records * 4, data_off
        ).reshape(self.max_cores, self.records, 4)
        # unbounded per-core host buffers — the decoupling queue. Chunks
        # append per drain; `read` consolidates into one array anchored at
        # `_base[c]` (the absolute index of its first event), and
        # `discard` trims consumed prefixes so the consolidation copy
        # stays bounded by the UNCONSUMED backlog, not the whole history
        # (retain_history=True keeps everything for to_trace()).
        self._chunks: list[list[np.ndarray]] = [[] for _ in range(n_cores)]
        self._solid: list[np.ndarray] = [
            np.zeros((0, 4), np.int32) for _ in range(n_cores)
        ]
        self._base = np.zeros(n_cores, np.int64)
        self.total = np.zeros(n_cores, np.int64)

    @property
    def producer_done(self) -> bool:
        hdr = np.frombuffer(self._mm, np.uint32, _HDR_WORDS, 0)
        return bool(hdr[6])

    def core_done(self, c: int) -> bool:
        state = int(self._ctl32[c, 4])
        if state == RSTATE_DONE:
            return True
        return state == RSTATE_UNUSED and self.producer_done

    def drain(self) -> int:
        """Pull all newly published records into host buffers; returns
        how many records moved."""
        moved = 0
        for c in range(self.n_cores):
            w = int(self._ctl64[c, 0])  # widx (producer release-stores)
            r = int(self._ctl64[c, 1])  # ridx (ours)
            if w == r:
                continue
            n = w - r
            lo = r % self.records
            hi = lo + n
            if hi <= self.records:
                chunk = self._data[c, lo:hi].copy()
            else:
                chunk = np.concatenate(
                    [self._data[c, lo:], self._data[c, : hi - self.records]]
                )
            self._chunks[c].append(chunk)
            self.total[c] += n
            moved += n
            self._ctl64[c, 1] = np.uint64(w)  # release the slots
        return moved

    def read(self, c: int, start: int, count: int) -> np.ndarray:
        """Events [start, start+count) of core c from the host buffers
        (must already be drained; start+count <= total[c], and start must
        not have been `discard`ed)."""
        if self._chunks[c]:
            self._solid[c] = np.concatenate([self._solid[c]] + self._chunks[c])
            self._chunks[c] = []
        lo = start - int(self._base[c])
        if lo < 0:
            raise ValueError(
                f"ring core {c}: events before {int(self._base[c])} were "
                "discarded"
            )
        return self._solid[c][lo : lo + count]

    def discard(self, c: int, upto: int) -> None:
        """Drop core c's events below absolute index `upto` (consumed by
        the simulation) — keeps online memory bounded by the backlog."""
        if self.retain_history:
            return
        drop = int(upto - self._base[c])
        if drop > 0 and self._solid[c].shape[0] >= drop:
            self._solid[c] = self._solid[c][drop:]
            self._base[c] += drop

    def dropped(self) -> int:
        return int(self._ctl64[: self.n_cores, 3].sum())

    def to_trace(self):
        """Materialize everything drained so far as a padded Trace — the
        capture-then-replay equivalent of the SAME execution (perf-based
        instruction batches are not reproducible across runs, so the
        online-vs-replay bit-exactness proof replays this stream).
        Requires `retain_history=True` (the production path discards
        consumed events)."""
        if self._base.any():
            raise ValueError("to_trace: history was discarded")
        C = self.n_cores
        lengths = (self.total + 1).astype(np.int32)
        max_len = int(lengths.max()) if C else 1
        events = np.zeros((C, max_len, N_FIELDS), np.int32)
        events[:, :, 0] = EV_END
        for c in range(C):
            n = int(self.total[c])
            if n:
                events[c, :n] = self.read(c, 0, n)
        return Trace(
            events, lengths, line_addressed=True, line_bits=self.line_bits
        )

    def close(self):
        # numpy views pin the mmap's exported buffer; drop them first
        self._ctl64 = self._ctl32 = self._data = None
        self._mm.close()
        self._f.close()
        if self._unlink:  # capture_online's mkstemp ring file
            try:
                os.unlink(self._path)
            except OSError:
                pass


class OnlineEngine:
    """Execution-driven simulation: drains a RingSource fed by the running
    target and simulates it through the windowed loop of StreamEngine,
    on `cuda` unless `device` names another device. Returns from `run`
    when the producer is done and every stream is consumed."""

    def __init__(
        self,
        cfg: MachineConfig,
        source: RingSource,
        window_events: int = 1024,
        poll_s: float = 0.002,
        idle_timeout_s: float = 120.0,
        device=None,
    ):
        check_port_supported(cfg)
        self.device = resolve_device(device)
        if cfg.faults_enabled:
            raise ValueError(FAULTS_REFUSED)
        if source.n_cores != cfg.n_cores:
            raise ValueError("ring n_cores != cfg.n_cores")
        if source.line_bits != cfg.line_bits:
            raise ValueError(
                f"ring captured {1 << source.line_bits}-byte lines but the "
                f"machine uses {cfg.l1.line}-byte lines"
            )
        if window_events < max(1, cfg.local_run_len + 1):
            raise ValueError(
                "window_events must cover at least one local run + 1 event"
            )
        # the shim caps an event's batch at 2^20; the window loop drains
        # the counters at least every 64 steps
        if 64 * (cfg.local_run_len + 1) * (1 << 20) >= 1 << (_ACC_BITS + 1):
            raise ValueError("local_run_len too large for online ingest")
        self.cfg = cfg
        self.src = source
        self.W = int(window_events)
        self.poll_s = poll_s
        self.idle_timeout_s = idle_timeout_s
        self.cursor = np.zeros(cfg.n_cores, np.int64)
        self.state = init_state(cfg, self.device)
        self.cycle_base = 0
        self.host_counters = zero_counters(cfg.n_cores)
        self.steps_run = 0
        self.window_chunks: list[int] = []  # host transfers of each window

    def _fill_window(self, done_before_drain):
        C = self.cfg.n_cores
        buf = np.zeros((C, self.W + 1, 4), np.int32)
        buf[:, :, 0] = EV_END
        filled = np.zeros(C, np.int32)
        exhausted = np.zeros(C, bool)
        for c in range(C):
            avail = int(self.src.total[c] - self.cursor[c])
            take = min(self.W, avail)
            if take:
                ev = self.src.read(c, int(self.cursor[c]), take)
                if ((ev[:, 0] == EV_BARRIER) & (ev[:, 2] >= self.cfg.barrier_slots)).any():
                    raise ValueError("captured barrier id >= cfg.barrier_slots")
                buf[c, :take] = ev
            filled[c] = take
            # exhaustion uses the DONE status seen BEFORE the last drain: a
            # thread whose exit flush landed between the drain and this
            # check has trailing events the drain missed, and the next
            # drain picks them up
            exhausted[c] = done_before_drain[c] and take == avail
        return buf, exhausted, filled

    def warmup(self) -> None:
        """Build and load the kernels before a timed region (no step
        runs), as StreamEngine.warmup does."""
        warm_kernels(self.cfg, self.device)

    def run(self, max_steps: int | None = None) -> None:
        cfg = self.cfg
        C = cfg.n_cores
        budget = max_steps if max_steps is not None else 1 << 62
        last_progress = time.monotonic()
        while True:
            done_before = [self.src.core_done(c) for c in range(C)]
            self.src.drain()
            buf, exhausted, filled = self._fill_window(done_before)
            # progress needs every live core to hold a whole step's events
            # (the window loop's exit margin); otherwise poll
            need = cfg.local_run_len + 1
            live_low = (~exhausted) & (filled < np.minimum(need, self.W))
            if not live_low.any():
                events = torch.from_numpy(buf).to(self.device)
                st = self.state._replace(
                    ptr=torch.zeros(C, dtype=torch.int32, device=self.device))
                # has_sync: unknown until the target finishes
                out = stream_loop(cfg, events, st, exhausted, filled,
                                  min(budget, 2**31 - 1), has_sync=True)
                k, consumed, at_end = absorb_stream_outputs(self, out, buf)
                budget -= k
                for c in range(C):  # free the consumed backlog (kept if retained)
                    self.src.discard(c, int(self.cursor[c]))
                if (at_end & exhausted).all():
                    return
                if budget <= 0:
                    raise RuntimeError("online engine: step budget exhausted")
                if k or consumed.any():
                    last_progress = time.monotonic()
                    continue
            # waiting on the target to produce more events
            if time.monotonic() - last_progress > self.idle_timeout_s:
                raise RuntimeError(
                    "online engine: no progress for "
                    f"{self.idle_timeout_s}s (target stalled or dead; "
                    f"consumed {int(self.cursor.sum())} events)"
                )
            time.sleep(self.poll_s)

    @property
    def cycles(self) -> np.ndarray:
        return self.state.cycles.cpu().numpy().astype(np.int64) + self.cycle_base

    @property
    def counters(self) -> dict[str, np.ndarray]:
        return self.host_counters
