"""Trace event format and binary trace files (a numpy copy of the JAX
package's `trace/format.py`, without the multiprogram `multiplex`).

TPU-native replacement for the reference's Pin-frontend event stream
(SURVEY.md §2 #1, §3.2/3.3: per-BBL instruction-count batching + per-access
`execMem(addr, size, R/W)` analysis calls). Events are fixed 4x int32
records so host->device ingest is a single contiguous copy and the C++
frontend (`primesim_tpu/frontend/`) can write the same format with one
fwrite.

The fourth field, `pre`, carries the count of non-memory instructions
retired immediately before a memory event — the PriME-style per-basic-block
batching (SURVEY.md §3.2) folded to memory-access boundaries. A trace using
explicit INS events (pre = 0 everywhere) and its `fold_ins()` image are the
same workload; folding retires each INS batch together with the following
access in ONE simulation step, which matters because steps, not events, are
the engine's unit of wall-clock cost.

Binary file layout (little-endian):
    magic   uint32  0x50545055  ("PTPU")
    version uint32  4   (v1: 3-field records, pre=0; v2: no sync events;
                         v3: no flags word)
    n_cores uint32
    max_len uint32  (padded per-core event count)
    flags   uint32  (v4+ only; bit 0 = line-addressed)
    lengths uint32[n_cores]  (true event count per core, <= max_len)
    events  int32[n_cores, max_len, 4]   (type, arg, addr, pre)

Cores with fewer than max_len events are padded with END events.

v3 adds the inter-thread synchronization events the reference's Pin
frontend captures by intercepting pthread_mutex/barrier calls (SURVEY.md
§2 #1, §3.5): LOCK/UNLOCK carry the mutex's byte address (hashed to a
lock-table slot by the engines), BARRIER carries a dense barrier id in
`addr` and the participant count in `arg`. All three use `pre` like
memory events. Timing/blocking semantics are DESIGN.md §3-sync.

v4 adds the `flags` header word. Flag bit 0 (`line_addressed`): the
`addr` field of LD/ST/LOCK/UNLOCK events holds a cache-LINE index, not a
byte address — widening the addressable range 64x, from 2^31 bytes (2
GiB) to 2^31 lines (128 GiB at 64-byte lines). Larger captured address
spaces still alias (the frontend masks line indices to 31 bits); a
2x32-bit record extension remains the path to fully un-aliased 48-bit
spaces. Flags bits 8-15 record log2(line size) at capture time; engines
reject line-addressed traces whose line size differs from the machine
config. Both engines normalize ingest to line granularity, so byte- and
line-addressed encodings of one workload simulate identically.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0x50545055
VERSION = 4
FLAG_LINE_ADDRESSED = 1

# Event types (DESIGN.md §2)
EV_INS = 0  # batch of non-memory instructions; arg = count
EV_LD = 1  # load;  addr = byte address (31-bit in v1), arg = size
EV_ST = 2  # store; addr = byte address (31-bit in v1), arg = size
EV_END = 3  # core finished
EV_LOCK = 4  # acquire mutex; addr = mutex byte address
EV_UNLOCK = 5  # release mutex; addr = mutex byte address
EV_BARRIER = 6  # barrier wait; addr = barrier id, arg = participant count

N_FIELDS = 4  # (type, arg, addr, pre)
SYNC_TYPES = (EV_LOCK, EV_UNLOCK, EV_BARRIER)


class TraceError(ValueError):
    """Typed trace load/validation error carrying WHERE the trace is bad:
    the source `path` (file loads), the `core` index, and the event
    `offset` within that core's row. Fleet fault isolation
    (sim/supervisor.py) surfaces these fields in the quarantined
    element's JSON line so a malformed element in a thousand-element
    sweep is diagnosable without rerunning it solo. Subclasses ValueError
    so existing `except ValueError` callers are unaffected."""

    def __init__(
        self,
        message: str,
        *,
        path: str | None = None,
        core: int | None = None,
        offset: int | None = None,
    ):
        self.reason = message
        self.path = path
        self.core = core
        self.offset = offset
        where = []
        if path is not None:
            where.append(str(path))
        if core is not None:
            where.append(f"core {core}")
        if offset is not None:
            where.append(f"event {offset}")
        super().__init__(": ".join(where + [message]) if where else message)

    def location(self) -> dict:
        """JSON-ready location fields (None entries omitted)."""
        loc = {"path": self.path, "core": self.core, "offset": self.offset}
        return {k: v for k, v in loc.items() if v is not None}


def _first_bad(mask: np.ndarray) -> tuple[int, int]:
    """(core, event offset) of the first True in a [n_cores, max_len] mask."""
    c, o = np.argwhere(mask)[0]
    return int(c), int(o)


class Trace:
    """Per-core event arrays: events[n_cores, max_len, 4] int32 records
    (type, arg, addr, pre). With `line_addressed`, LD/ST/LOCK/UNLOCK addr
    fields hold cache-line indices instead of byte addresses (v4 flag)."""

    def __init__(
        self,
        events: np.ndarray,
        lengths: np.ndarray,
        line_addressed: bool = False,
        line_bits: int | None = None,
        validate: bool = True,
    ):
        """`validate=False` skips the eager whole-array scans (used by the
        mmap load path, where touching every page defeats lazy loading;
        the engines' ingest checks still apply per window)."""
        if validate:
            events = np.asarray(events, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        assert events.ndim == 3 and events.shape[2] == N_FIELDS
        assert lengths.shape == (events.shape[0],)
        self.line_addressed = bool(line_addressed)
        # line size (log2) the line indices were derived with; None =
        # unknown/not applicable (byte-addressed traces)
        self.line_bits = line_bits if line_addressed else None
        t = events[:, :, 0] if validate else np.zeros(0)
        if t.size:
            bad = ~((t >= EV_INS) & (t <= EV_BARRIER))
            if bad.any():
                c, o = _first_bad(bad)
                raise TraceError(
                    "trace contains invalid event types", core=c, offset=o
                )
            mem = (t == EV_LD) | (t == EV_ST) | (t == EV_LOCK) | (t == EV_UNLOCK)
            bad = mem & (events[:, :, 2] < 0)
            if bad.any():
                c, o = _first_bad(bad)
                raise TraceError(
                    "addresses must be in [0, 2^31) (31-bit)", core=c, offset=o
                )
            bad = (t == EV_INS) & (events[:, :, 1] < 0)
            if bad.any():
                c, o = _first_bad(bad)
                raise TraceError(
                    "INS batch counts must be >= 0", core=c, offset=o
                )
            bar = t == EV_BARRIER
            bad = bar & (events[:, :, 2] < 0)
            if bad.any():
                c, o = _first_bad(bad)
                raise TraceError("barrier ids must be >= 0", core=c, offset=o)
            bad = bar & (events[:, :, 1] < 1)
            if bad.any():
                c, o = _first_bad(bad)
                raise TraceError(
                    "barrier participant counts must be >= 1", core=c, offset=o
                )
            bad = (mem | bar) & (events[:, :, 3] < 0)
            if bad.any():
                c, o = _first_bad(bad)
                raise TraceError(
                    "pre-batched instruction counts must be >= 0",
                    core=c, offset=o,
                )
            badlen = (lengths > events.shape[1]) | (lengths < 1)
            if badlen.any():
                raise TraceError(
                    "per-core lengths out of range",
                    core=int(np.argwhere(badlen)[0][0]),
                )
            # every core's row must terminate: the event at lengths-1 is END
            # and padding beyond it is END (engines clamp ptr to max_len-1)
            last = events[np.arange(events.shape[0]), lengths - 1, 0]
            bad_last = last != EV_END
            bad_pad = events[:, -1, 0] != EV_END
            if bad_last.any() or bad_pad.any():
                if bad_last.any():
                    c = int(np.argwhere(bad_last)[0][0])
                    o = int(lengths[c]) - 1
                else:
                    c = int(np.argwhere(bad_pad)[0][0])
                    o = events.shape[1] - 1
                raise TraceError(
                    "every core's event row must terminate with END",
                    core=c, offset=o,
                )
        self.events = events
        self.lengths = lengths

    @property
    def n_cores(self) -> int:
        return self.events.shape[0]

    @property
    def max_len(self) -> int:
        return self.events.shape[1]

    def total_instructions(self) -> int:
        """Total simulated instructions (INS + pre-batched + 1 per mem/sync op)."""
        t = self.events[:, :, 0]
        ins = np.where(t == EV_INS, self.events[:, :, 1], 0).astype(np.int64).sum()
        op_mask = (t != EV_INS) & (t != EV_END)  # mem + sync events
        pre = np.where(op_mask, self.events[:, :, 3], 0).astype(np.int64).sum()
        return int(ins) + int(pre) + int(op_mask.sum())

    def line_events(self, line_bits: int) -> np.ndarray:
        """Events normalized to LINE-granular addresses (the engines'
        internal form): LD/ST/LOCK/UNLOCK addr fields become line indices;
        barrier ids and all other fields pass through. Line-addressed
        traces return the SHARED events array (engines never mutate it);
        their recorded line size must match the machine's."""
        if self.line_addressed:
            if self.line_bits is not None and self.line_bits != line_bits:
                raise ValueError(
                    f"trace was captured with {1 << self.line_bits}-byte "
                    f"lines but the machine uses {1 << line_bits}-byte lines"
                )
            return self.events
        ev = self.events.copy()
        t = ev[:, :, 0]
        addr_ev = (t == EV_LD) | (t == EV_ST) | (t == EV_LOCK) | (t == EV_UNLOCK)
        ev[:, :, 2] = np.where(addr_ev, ev[:, :, 2] >> line_bits, ev[:, :, 2])
        return ev

    # ---------------------------------------------------------------- I/O

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            hdr = np.array([MAGIC, VERSION, self.n_cores, self.max_len], dtype="<u4")
            hdr.tofile(f)
            fl = FLAG_LINE_ADDRESSED if self.line_addressed else 0
            if self.line_addressed and self.line_bits is not None:
                fl |= (self.line_bits & 0xFF) << 8
            np.array([fl], dtype="<u4").tofile(f)
            self.lengths.astype("<u4").tofile(f)
            self.events.astype("<i4").tofile(f)

    @staticmethod
    def load(path: str, mmap: bool = False) -> "Trace":
        """Load a PTPU trace; `mmap=True` memory-maps the event array so
        host memory stays O(1) — pair with ingest.stream.StreamEngine for
        traces larger than host/device memory. mmap skips the eager
        whole-array validation pass (windows still hit engine checks) and
        requires a 4-field (v2+) file.
        """
        with open(path, "rb") as f:
            hdr = np.fromfile(f, dtype="<u4", count=4)
            if hdr.shape[0] != 4 or hdr[0] != MAGIC:
                raise TraceError("not a primesim_tpu trace file", path=path)
            if hdr[1] not in (1, 2, 3, 4):
                raise TraceError(
                    f"unsupported trace version {hdr[1]}", path=path
                )
            nf = 3 if hdr[1] == 1 else N_FIELDS
            flags = 0
            if hdr[1] >= 4:
                fw = np.fromfile(f, dtype="<u4", count=1)
                if fw.shape[0] != 1:
                    raise TraceError("truncated trace file", path=path)
                flags = int(fw[0])
            n_cores, max_len = int(hdr[2]), int(hdr[3])
            lengths = np.fromfile(f, dtype="<u4", count=n_cores).astype(np.int32)
            lb = (flags >> 8) & 0xFF
            line_addressed = bool(flags & FLAG_LINE_ADDRESSED)
            if mmap:
                if nf != N_FIELDS:
                    raise TraceError(
                        "mmap loading requires a 4-field (v2+) trace; "
                        "this is v1",
                        path=path,
                    )
                events = np.memmap(
                    path, dtype="<i4", mode="r", offset=f.tell(),
                    shape=(n_cores, max_len, nf),
                )
                return Trace(
                    events,
                    lengths,
                    line_addressed=line_addressed,
                    line_bits=lb if lb else None,
                    validate=False,
                )
            events = np.fromfile(f, dtype="<i4", count=n_cores * max_len * nf)
            if events.size != n_cores * max_len * nf:
                raise TraceError("truncated trace file", path=path)
            events = events.reshape(n_cores, max_len, nf).astype(np.int32)
            if nf == 3:  # v1: no pre field
                events = np.concatenate(
                    [events, np.zeros((n_cores, max_len, 1), np.int32)], axis=2
                )
        try:
            return Trace(
                events,
                lengths,
                line_addressed=line_addressed,
                line_bits=lb if lb else None,
            )
        except TraceError as e:
            # re-raise with the file path attached to the core/offset info
            raise TraceError(
                e.reason, path=path, core=e.core, offset=e.offset
            ) from None


def validate_sync(trace: Trace, barrier_slots: int) -> None:
    """Reject traces whose barrier ids exceed a machine's slot table.

    Shared by both engines (golden + JAX) so they accept exactly the same
    traces; barrier ids are dense ints < barrier_slots by contract.
    """
    _, _, bad_bid = scan_trace_meta(trace, barrier_slots)
    if bad_bid:
        raise TraceError(
            f"trace uses barrier ids >= barrier_slots={barrier_slots}",
            core=bad_bid[0],
            offset=bad_bid[1],
        )


def scan_trace_meta(
    trace: Trace,
    barrier_slots: int,
    max_chunk_records: int = 1 << 24,
) -> tuple[bool, int, tuple[int, int] | None]:
    """One bounded-memory pass over a (possibly memory-mapped) trace:
    returns (has_sync, max per-event instruction batch, location of the
    first barrier id >= barrier_slots as (core, offset) — or None when
    all ids fit). Tiled along BOTH axes with the tile sizes co-tuned so
    one chunk holds at most `max_chunk_records` records (~256 MB at the
    default), never O(file) — row-only chunking still materialized
    rows * max_len records, which for a few-cores/very-long trace (the
    streaming engine's target shape) could itself exceed RAM."""
    has_sync = False
    per_ev = 1
    bad_bid: tuple[int, int] | None = None
    events_per_chunk = min(trace.max_len, max_chunk_records)
    rows_per_chunk = max(1, max_chunk_records // events_per_chunk)
    for lo in range(0, trace.n_cores, rows_per_chunk):
        for elo in range(0, trace.max_len, events_per_chunk):
            ev = np.asarray(
                trace.events[
                    lo : lo + rows_per_chunk, elo : elo + events_per_chunk
                ]
            )
            t = ev[:, :, 0]
            if not has_sync:
                has_sync = bool(
                    ((t == EV_LOCK) | (t == EV_UNLOCK) | (t == EV_BARRIER)).any()
                )
            per_ev = max(
                per_ev,
                int(ev[:, :, 1].max(initial=0)),
                int(ev[:, :, 3].max(initial=0)) + 1,
            )
            if bad_bid is None:
                over = (t == EV_BARRIER) & (ev[:, :, 2] >= barrier_slots)
                if over.any():
                    c, o = np.argwhere(over)[0]
                    bad_bid = (int(c) + lo, int(o) + elo)
    return has_sync, per_ev, bad_bid


def from_event_lists(
    per_core: list[list[tuple]], line_addressed: bool = False
) -> Trace:
    """Build a padded Trace from python per-core event lists.

    Each event is (type, arg, addr) or (type, arg, addr, pre); pre defaults
    to 0. An END event is appended to every core.
    """
    n_cores = len(per_core)
    lengths = np.array([len(evs) + 1 for evs in per_core], dtype=np.int32)
    max_len = int(lengths.max()) if n_cores else 1
    events = np.zeros((n_cores, max_len, N_FIELDS), dtype=np.int32)
    events[:, :, 0] = EV_END
    for c, evs in enumerate(per_core):
        if evs:
            arr = np.asarray(
                [tuple(e) + (0,) * (N_FIELDS - len(e)) for e in evs],
                dtype=np.int64,
            )
            e = np.empty((len(evs), N_FIELDS), dtype=np.int32)
            e[:, 0] = arr[:, 0].astype(np.int32)
            e[:, 1] = arr[:, 1].astype(np.int32)
            oob = (arr[:, 2] < 0) | (arr[:, 2] >= 2**31)
            if oob.any():
                raise TraceError(
                    "addresses must be in [0, 2^31) (31-bit)",
                    core=c,
                    offset=int(np.argwhere(oob)[0][0]),
                )
            e[:, 2] = arr[:, 2].astype(np.int32)
            e[:, 3] = arr[:, 3].astype(np.int32)
            events[c, : len(evs)] = e
    return Trace(events, lengths, line_addressed=line_addressed)


def from_arrays(
    events: np.ndarray, lengths=None, line_addressed: bool = False
) -> Trace:
    """`from_event_lists` for events already in one int64 array
    [n_cores, n, 4] (type, arg, addr, pre), core c's first `lengths[c]`
    rows its events (all n when `lengths` is None): the same address
    check, the same int32 wrap of each field, and an END after each
    core's events."""
    n_cores, n = events.shape[:2]
    lengths = np.full(n_cores, n) if lengths is None else np.asarray(lengths)
    live = np.arange(n)[None, :] < lengths[:, None]
    oob = live & ((events[:, :, 2] < 0) | (events[:, :, 2] >= 2**31))
    if oob.any():
        c, o = _first_bad(oob)
        raise TraceError("addresses must be in [0, 2^31) (31-bit)", core=c, offset=o)
    out = np.zeros((n_cores, int(lengths.max(initial=0)) + 1, N_FIELDS), np.int32)
    out[:, :, 0] = EV_END
    out[:, :n][live] = events[live].astype(np.int32)
    return Trace(out, (lengths + 1).astype(np.int32), line_addressed=line_addressed)


def fold_ins(trace: Trace) -> Trace:
    """Fold INS batches into the following memory/sync event's `pre` field.

    The folded trace is the same workload expressed in PriME's per-BBL
    batched form (SURVEY.md §3.2): each batch of non-memory instructions
    retires in the same simulation step as the memory/sync operation that
    follows it. INS batches not followed by one (trailing work before END)
    are kept as explicit INS events.

    Whole-array numpy, event for event the JAX package's per-core loop: a
    kept event's batch is the INS args summed (int64) since the previous
    kept event or END, and an END after a batch leaves it as one INS
    event (every row ends with END: `Trace` checks it).
    """
    ev = trace.events.astype(np.int64)
    C, T = ev.shape[:2]
    rows = np.arange(C)
    idx = np.arange(T)
    live = idx[None, :] < np.asarray(trace.lengths)[:, None]
    t = ev[:, :, 0]
    is_ins = live & (t == EV_INS)
    is_end = live & (t == EV_END)
    kept = live & ~is_ins & ~is_end
    closer = kept | is_end  # where a batch ends
    csum = np.cumsum(np.where(is_ins, ev[:, :, 1], 0), axis=1)
    # each closer's batch: the INS sum since the previous closer
    last = np.maximum.accumulate(np.where(closer, idx, -1), axis=1)
    prev = np.concatenate([np.full((C, 1), -1), last[:, :-1]], axis=1)
    acc = csum - np.where(prev >= 0, np.take_along_axis(csum, np.maximum(prev, 0), 1), 0)
    flush = is_end & (acc != 0)  # a batch with no kept event after it
    out = np.where(kept[:, :, None], ev, 0)
    out[:, :, 3] += np.where(kept, acc, 0)
    out[flush, 0] = EV_INS
    out[flush, 1] = acc[flush]
    emit = kept | flush
    n = emit.sum(1)
    packed = np.zeros((C, int(n.max(initial=0)), N_FIELDS), np.int64)
    r = np.broadcast_to(rows[:, None], emit.shape)
    packed[r[emit], (np.cumsum(emit, axis=1) - 1)[emit]] = out[emit]
    return from_arrays(packed, n, line_addressed=trace.line_addressed)
