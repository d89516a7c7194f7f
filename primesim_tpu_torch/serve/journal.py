"""Crash-safe job journal — a segmented WAL for the serving daemon
(DESIGN.md §14, §18).

The journal is a sequence of append-only JSON-lines SEGMENTS in the
state directory. The ACTIVE segment is always `journal.jsonl`; when it
reaches `segment_records` records it is rolled: closed, renamed to
`journal-<seq:06d>.jsonl`, and a fresh active segment is opened whose
first record is a framed header

    {"t": "seg", "seq": <n>, "prev": <crc32 of the rolled segment's
                                      last raw line>}

so the segment chain is both SEQUENCE-NUMBERED and CRC-CHAINED: a
deleted middle segment is a sequence gap, a substituted one breaks the
chain — both raise `JournalCorrupt`, never a silent skip. A journal
that never rolled is byte-identical to the legacy single-file format
(headerless seq-0 active segment), so old state directories replay
unchanged.

Durability discipline mirrors `checkpoint.atomic_save_npz` adapted to an
append-only log:

- every record is framed `{"c": crc32(payload_json), "r": payload}` so a
  torn or bit-rotted line is detected before it is trusted;
- `append()` writes the line, flushes, and `fsync`s BEFORE returning —
  the server only ACKs a submission after its accept record is durable,
  which is the whole crash-safety invariant: ACKed => journaled =>
  replayed => reaches a terminal state;
- the journal directory is fsynced at creation and after every segment
  rename, so the files' own existence survives power loss.

Replay walks the segments in sequence order and tolerates a torn TAIL
(the one partial line a crash mid-append can leave) ONLY in the newest
segment — rolled segments were closed at a clean record boundary, so
any bad line inside one is media rot and raises `JournalCorrupt`, as
does a bad record followed by valid ones inside the active segment.
Before its first append a reopened journal REPAIRS a torn tail by
truncating it (the torn line was never ACKed): appending after a torn
line would otherwise concatenate into it and turn a tolerated tail into
mid-file corruption on the next replay.

COMPACTION (snapshot + truncate): with a `compactor` — a function
`records -> records` that must preserve the journal's fold (serve:
`serve_compactor` via `fold_records`; pool: `units.pool_compactor` via
`fold_unit_records`) — the journal periodically folds its whole history
into a minimal equivalent record list and rewrites it as a single
snapshot-BASE segment (`"base": true` in its header), then deletes the
older segments. Replay starts at the newest base segment; older
leftovers (a crash between the atomic snapshot rename and the deletes)
are ignored, so compaction is crash-safe at every instant.

Record types (`t` field): `accept` (the Job accept_record), `state`
(job_id + new state + detail/result), `drain` (clean shutdown marker),
`note` (operator annotations), `seg` (segment header, filtered out of
`replay()` results), `epoch` (fencing epoch, replicate.py — preserved
across compaction by `compact()` itself, since no domain compactor
knows about it), plus the pool ledger types (units.py).

The JAX package's `serve/journal.py`, copied whole for the port (it touches no
device), so the two packages' daemons, clients and state directories
speak one protocol and one journal format.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib

from ..chaos import sites as chaos
from ..obs.metrics import Histogram
from ..util import diskpressure

#: default active-segment record cap before a roll; None = never roll
#: (the legacy single-file behavior)
DEFAULT_SEGMENT_RECORDS = 512

#: rolled-segment count that triggers compaction (when a compactor is set)
DEFAULT_COMPACT_SEGMENTS = 4

_SEG_RE = re.compile(r"^journal-(\d{6})\.jsonl$")


class JournalCorrupt(ValueError):
    """Journal corruption that cannot be a torn append: a record failing
    its CRC ahead of valid ones, a bad line in a rolled (closed) segment,
    a missing segment in the sequence, or a broken segment CRC chain."""


def _frame(rec: dict) -> str:
    payload = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    return json.dumps(
        {"c": zlib.crc32(payload.encode()), "r": rec},
        sort_keys=True,
        separators=(",", ":"),
    )


def _unframe(line: str) -> dict | None:
    """Decode + CRC-verify one journal line; None when unusable."""
    try:
        obj = json.loads(line)
        rec = obj["r"]
        payload = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        if zlib.crc32(payload.encode()) != int(obj["c"]):
            return None
        return rec
    except (ValueError, KeyError, TypeError):
        return None


def _line_crc(line: str) -> int:
    return zlib.crc32(line.encode())


def _scan_lines(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [ln for ln in f.read().splitlines() if ln.strip()]


class JobJournal:
    """Append-only fsynced record log: active segment
    `directory/journal.jsonl` plus rolled `journal-NNNNNN.jsonl`."""

    def __init__(
        self,
        directory: str,
        segment_records: int | None = DEFAULT_SEGMENT_RECORDS,
        compactor=None,
        compact_segments: int = DEFAULT_COMPACT_SEGMENTS,
    ):
        self.dir = str(directory)
        self.path = os.path.join(self.dir, "journal.jsonl")
        self.segment_records = segment_records
        self.compactor = compactor
        self.compact_segments = int(compact_segments)
        fresh = not os.path.isdir(self.dir)
        os.makedirs(self.dir, exist_ok=True)
        if fresh:
            dfd = os.open(
                os.path.dirname(os.path.abspath(self.dir)) or ".",
                os.O_RDONLY,
            )
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        # crash mid-roll: the rename committed but the new active segment
        # was never created — recreate it so the chain stays closed
        rolled = self._rolled_segments()
        if rolled and not os.path.exists(self.path):
            last_lines = _scan_lines(rolled[-1][1])
            self._open_active(
                seq=rolled[-1][0] + 1,
                prev_crc=_line_crc(last_lines[-1]) if last_lines else 0,
            )
        else:
            self._f = open(self.path, "a", encoding="utf-8")
            self._active_seq, self._active_records, self._last_crc = \
                self._scan_active()
        # torn-tail repair is LAZY (first append): replay() must still
        # report the torn line of a journal that is only being read
        self._tail_checked = False
        self.appended = 0
        self.segments_rolled = 0
        self.compactions = 0
        # always-on fsync latency histogram (Prometheus `metrics` verb);
        # obs is an optional Recorder that additionally puts each fsync
        # on the flight-recorder timeline
        self.fsync_hist = Histogram()
        self.obs = None
        # optional replication sink (serve/replicate.py): called AFTER
        # the local fsync with the exact raw bytes on disk, so follower
        # chains stay byte-identical to this one
        self.sink = None
        # disk-pressure ladder: compaction folds rolled segments into
        # one base segment, the only space the journal may legally give
        # back — ACKed state itself is never an eviction candidate
        if self.compactor is not None:
            diskpressure.register_compactor(
                f"journal:{self.dir}", self.compact
            )

    # ---- segment bookkeeping ---------------------------------------------

    def _rolled_segments(self) -> list[tuple[int, str]]:
        """(seq, path) of every rolled segment, ascending by seq."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    def _scan_active(self) -> tuple[int, int, int]:
        """(seq, record count, last-valid-line crc) of the active segment
        as it sits on disk. Tolerant: corruption is replay()'s problem."""
        lines = _scan_lines(self.path)
        seq, n, last_crc = 0, 0, 0
        for i, line in enumerate(lines):
            rec = _unframe(line)
            if rec is None:
                continue
            if i == 0 and rec.get("t") == "seg":
                seq = int(rec.get("seq", 0))
            else:
                n += 1
            last_crc = _line_crc(line)
        return seq, n, last_crc

    def _open_active(self, seq: int, prev_crc: int, base: bool = False,
                     initial: list[dict] | None = None) -> None:
        """Create a fresh active segment (header first) atomically: built
        under a temp name, fsynced, then renamed over `journal.jsonl`."""
        header = {"t": "seg", "seq": int(seq), "prev": int(prev_crc)}
        if base:
            header["base"] = True
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            line = _frame(header)
            f.write(line + "\n")
            last = line
            for rec in initial or []:
                line = _frame(rec)
                f.write(line + "\n")
                last = line
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._fsync_dir()
        self._f = open(self.path, "a", encoding="utf-8")
        self._active_seq = int(seq)
        self._active_records = len(initial or [])
        self._last_crc = _line_crc(last)

    def _fsync_dir(self) -> None:
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _repair_tail(self) -> None:
        """Truncate trailing torn lines before the first append of this
        process — a torn line was never ACKed, and appending after it
        would concatenate into mid-file corruption."""
        lines = []
        trailing_newline = True
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                raw = f.read()
            trailing_newline = (raw == "") or raw.endswith("\n")
            lines = raw.splitlines()
        bad_at = None
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            if _unframe(line) is None:
                if bad_at is None:
                    bad_at = i
            elif bad_at is not None:
                return  # mid-file rot: leave it for replay() to raise
        if bad_at is None and trailing_newline:
            return
        keep = lines[:bad_at] if bad_at is not None else lines
        self._f.close()
        with open(self.path, "w", encoding="utf-8") as f:
            for line in keep:
                f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._f = open(self.path, "a", encoding="utf-8")
        self._active_seq, self._active_records, self._last_crc = \
            self._scan_active()

    def _roll(self) -> None:
        """Close the active segment at a record boundary, rename it into
        the rolled sequence, and chain a fresh active segment to it."""
        self._f.close()
        rolled_path = os.path.join(
            self.dir, f"journal-{self._active_seq:06d}.jsonl"
        )
        os.replace(self.path, rolled_path)
        self._fsync_dir()
        self._open_active(seq=self._active_seq + 1, prev_crc=self._last_crc)
        self.segments_rolled += 1
        if self.sink is not None:
            header_lines = _scan_lines(self.path)
            if header_lines:
                self.sink.on_roll(self._active_seq, header_lines[0])
        if (
            self.compactor is not None
            and len(self._rolled_segments()) >= self.compact_segments
        ):
            self.compact()

    # ---- write side ------------------------------------------------------

    def append(self, rec: dict) -> None:
        """Durably append one record: write + flush + fsync. The caller
        may ACK the fact the record carries only AFTER this returns."""
        if not self._tail_checked:
            self._tail_checked = True
            self._repair_tail()
        if (
            self.segment_records is not None
            and self._active_records >= self.segment_records
        ):
            self._roll()
        t0 = time.perf_counter()
        line = _frame(rec)
        prev_crc = self._last_crc
        # disk-pressure gate: on a full disk this evicts caches/rotated
        # snapshots, compacts the journal, and raises DiskPressureError
        # (admission backpressure) BEFORE the append half-lands — the
        # record was not ACKed, so refusing it loses nothing
        diskpressure.preflight(self.path, len(line) + 1, kind="journal")
        chaos.durable("journal.append", f=self._f, data=line + "\n")
        self._f.write(line + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        dt = time.perf_counter() - t0
        self._last_crc = _line_crc(line)
        self._active_records += 1
        self.appended += 1
        self.fsync_hist.observe(dt)
        if self.obs is not None:
            self.obs.fsync_event(dt)
        if self.sink is not None:
            # locally durable first, then the wire: the sink ships the
            # raw line and books the quorum; the SERVER decides whether
            # an under-quorum frame may still be ACKed (quorum policy)
            self.sink.on_append(line, self._active_seq, prev_crc)

    def accept(self, job) -> None:
        self.append({"t": "accept", "job": job.accept_record()})

    def state(self, job_id: str, state: str, detail: dict | None = None,
              result: dict | None = None) -> None:
        rec = {"t": "state", "job_id": job_id, "state": state}
        if detail:
            rec["detail"] = detail
        if result is not None:
            rec["result"] = result
        self.append(rec)

    def note(self, msg: str) -> None:
        self.append({"t": "note", "msg": str(msg)})

    def drain(self) -> None:
        self.append({"t": "drain"})

    def close(self) -> None:
        diskpressure.unregister(f"journal:{self.dir}")
        try:
            self._f.close()
        except OSError:
            pass

    # ---- compaction ------------------------------------------------------

    def compact(self) -> int:
        """Snapshot + truncate: fold the whole history through the
        compactor into a minimal equivalent record list, write it as a
        fresh BASE segment (atomic rename over the active segment), then
        delete the older segments. Returns the compacted record count.
        Crash-safe: until the rename commits, the old chain is intact;
        after it, replay starts at the new base and ignores leftovers."""
        if self.compactor is None:
            raise RuntimeError("journal has no compactor configured")
        records, _ = self.replay()
        kept = list(self.compactor(records))
        # the fencing epoch (replicate.py) must survive compaction even
        # though domain compactors only know their own record types: a
        # BASE that propagated to every replica is the ONLY copy of the
        # chain left, and losing the epoch frame would let epochs
        # regress after a restart — a stale primary could rejoin
        # un-fenced, or a new reign could reuse a fenced epoch number.
        # Re-emit the highest epoch frame first, where a reign puts it.
        fence = None
        for rec in records:
            if rec.get("t") == "epoch" and (
                fence is None
                or int(rec.get("epoch", 0)) > int(fence.get("epoch", 0))
            ):
                fence = rec
        if fence is not None and not any(
            r.get("t") == "epoch" for r in kept
        ):
            kept.insert(0, fence)
        stale = self._rolled_segments()
        self._f.close()
        self._open_active(
            seq=self._active_seq + 1, prev_crc=0, base=True, initial=kept
        )
        for _, path in stale:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._fsync_dir()
        self.compactions += 1
        if self.sink is not None:
            # history was rewritten under the followers: resync them
            # from the new BASE before the next per-frame order
            self.sink.on_base()
        self.append({
            "t": "note",
            "msg": f"compacted: {len(records)} records -> {len(kept)}",
        })
        return len(kept)

    # ---- read side -------------------------------------------------------

    def _parse_segment(
        self, path: str, newest: bool
    ) -> tuple[dict | None, list[dict], int, int]:
        """One segment -> (header, records, last-valid-line crc, torn
        lines dropped). Only the NEWEST segment may have a torn tail;
        anywhere else a bad line raises JournalCorrupt."""
        lines = _scan_lines(path)
        header: dict | None = None
        records: list[dict] = []
        last_crc = 0
        bad_at: int | None = None
        for n, line in enumerate(lines):
            rec = _unframe(line)
            if rec is None:
                if not newest:
                    raise JournalCorrupt(
                        f"{path}: record at line {n + 1} fails CRC in a "
                        "closed segment — media rot, not a torn append"
                    )
                if bad_at is None:
                    bad_at = n
                continue
            if bad_at is not None:
                raise JournalCorrupt(
                    f"{path}: record at line {bad_at + 1} fails CRC "
                    f"but line {n + 1} is valid — mid-file corruption"
                )
            if n == 0 and rec.get("t") == "seg":
                header = rec
            else:
                records.append(rec)
            last_crc = _line_crc(line)
        dropped = (len(lines) - bad_at) if bad_at is not None else 0
        return header, records, last_crc, dropped

    def replay(self) -> tuple[list[dict], int]:
        """All valid records across the segment chain in append order,
        plus the count of dropped torn-TAIL lines (0 on a clean log).
        Raises JournalCorrupt on mid-file rot, a bad line in a closed
        segment, a sequence gap, or a broken segment CRC chain."""
        segments = self._rolled_segments()
        if os.path.exists(self.path):
            active_seq = self._scan_active()[0] if segments else \
                getattr(self, "_active_seq", 0)
            # trust the on-disk header over cached state: replay() must
            # see what a fresh process would see
            lines = _scan_lines(self.path)
            if lines:
                first = _unframe(lines[0])
                if first is not None and first.get("t") == "seg":
                    active_seq = int(first.get("seq", active_seq))
            segments = segments + [(active_seq, self.path)]
        if not segments:
            return [], 0
        parsed = []  # (seq, path, header, records, last_crc, dropped)
        for seq, path in segments:
            header, records, last_crc, dropped = self._parse_segment(
                path, newest=(path == segments[-1][1])
            )
            if header is not None and int(header.get("seq", seq)) != seq:
                raise JournalCorrupt(
                    f"{path}: segment header seq {header.get('seq')} does "
                    f"not match its position {seq} in the chain"
                )
            parsed.append((seq, path, header, records, last_crc, dropped))
        # replay starts at the newest BASE segment (compaction snapshot);
        # anything older is a crash-window leftover and is ignored
        start = 0
        for i, (_, _, header, _, _, _) in enumerate(parsed):
            if header is not None and header.get("base"):
                start = i
        parsed = parsed[start:]
        # sequence contiguity + CRC chain from the base onward
        for k in range(1, len(parsed)):
            prev_seq, _, _, _, prev_crc, _ = parsed[k - 1]
            seq, path, header, _, _, _ = parsed[k]
            if seq != prev_seq + 1:
                raise JournalCorrupt(
                    f"{self.dir}: journal segment {prev_seq + 1} is "
                    f"missing (found {seq} after {prev_seq})"
                )
            if header is None:
                raise JournalCorrupt(
                    f"{path}: segment {seq} has no header but is not the "
                    "base of the chain"
                )
            if int(header.get("prev", -1)) != prev_crc:
                raise JournalCorrupt(
                    f"{path}: segment {seq} chain CRC mismatch — the "
                    f"preceding segment is not the one it was rolled from"
                )
        records: list[dict] = []
        dropped = 0
        for _, _, _, recs, _, d in parsed:
            records.extend(recs)
            dropped += d
        return records, dropped


def fold_records(records: list[dict]):
    """Fold a replayed record stream into the job table the scheduler
    restarts from: `(jobs, clean_drain)` where `jobs` maps job_id ->
    rebuilt Job (terminal jobs carry their journaled result; non-terminal
    ones are back in PENDING, ready to re-enqueue) and `clean_drain` is
    True when the log ends with a drain marker (graceful shutdown).

    The fold is FIRST-TERMINAL-WINS and duplicate-tolerant — the
    property the pool coordinator's lease-epoch/first-ACK-wins protocol
    (DESIGN.md §17) leans on when it reuses this journal:

    - a duplicate `accept` for a known job_id is ignored (re-accepting
      must not resurrect a job that already reached a terminal state);
    - once a job is terminal, later non-terminal records (a RUNNING
      record from a hedged or re-leased attempt, delivered out of order)
      do not demote it, and later terminal records do not overwrite the
      first result."""
    from .jobs import RUNNING, TERMINAL_STATES, Job

    jobs: dict[str, Job] = {}
    clean_drain = False
    for rec in records:
        t = rec.get("t")
        if t == "accept":
            job = Job.from_accept_record(rec["job"])
            if job.job_id not in jobs:  # duplicate accept: first wins
                jobs[job.job_id] = job
            clean_drain = False
        elif t == "state":
            job = jobs.get(rec["job_id"])
            if job is None:
                continue  # state for a job we never saw accepted
            state = rec["state"]
            if job.state in TERMINAL_STATES:
                # terminal is forever: a late RUNNING (out-of-order
                # redispatch) or a duplicate terminal (second ACK of a
                # hedged pair) never rewrites the first outcome
                clean_drain = False
                continue
            if state in TERMINAL_STATES:
                job.state = state
                job.detail = rec.get("detail") or {}
                job.result = rec.get("result")
                job.finished_t = job.accepted_t  # latency lost across crash
            elif state == RUNNING:
                # mid-flight at crash: back to PENDING for re-admission
                job.state = "PENDING"
            clean_drain = False
        elif t == "drain":
            clean_drain = True
    return jobs, clean_drain


def serve_compactor(records: list[dict]) -> list[dict]:
    """Compaction fold for the SERVE journal: re-emit the minimal record
    list whose `fold_records` equals the original history's — one accept
    per job, one terminal state record per finished job, the drain marker
    when the log ended clean. Idempotent: compacting a compacted journal
    is a no-op fold-wise."""
    from .jobs import TERMINAL_STATES

    jobs, clean = fold_records(records)
    out: list[dict] = []
    for job in jobs.values():
        out.append({"t": "accept", "job": job.accept_record()})
        if job.state in TERMINAL_STATES:
            rec = {"t": "state", "job_id": job.job_id, "state": job.state}
            if job.detail:
                rec["detail"] = job.detail
            if job.result is not None:
                rec["result"] = job.result
            out.append(rec)
    if clean:
        out.append({"t": "drain"})
    return out
