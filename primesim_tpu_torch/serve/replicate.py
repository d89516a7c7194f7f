"""Journal replication + fenced hot-standby failover (DESIGN.md §21),
the JAX package's `serve/replicate.py` for the port. It touches no
device: a replica process never initialises CUDA. The wire verbs, the
frames and the segment chains are the JAX package's byte for byte, so a
primary of either package replicates to a replica of either package.

The crash-safety story so far (§14/§18) bottoms out in ONE fsynced
journal chain on ONE filesystem: kill -9 of any process is survivable,
losing the front-end HOST (or its disk) is not. This module closes that
hole with classic primary-backup quorum commit:

- the primary's `JobJournal` streams every appended frame — and every
  segment roll / compaction BASE — to N follower replicas over the same
  JSON-lines protocol the front door speaks (`repl.*` verbs);
- frames travel as RAW framed lines, so a follower's segment chain is
  byte-identical to the primary's (same CRCs, same headers, same roll
  points) and `fsck --compare` can hold the two directories to
  frame-for-frame agreement;
- `append()` reports quorum only after K replicas ACKed an fsync of the
  frame (default K = a strict majority of the N replicas, `N//2 + 1`;
  any explicit `--quorum` must satisfy `2K > N`, the intersection
  property the fencing argument stands on). The SERVER only ACKs a
  submit whose accept record reached quorum — ACKed now means "on K+1
  disks", not "on one disk";
- a follower that was down catches up on reconnect: the primary reads
  its tip (active seq + record count + last chained CRC), verifies the
  tip CRC against its own chain at the identical position (seq ranges
  alone cannot prove a byte-prefix once a diverged tail has crossed a
  roll boundary), and re-ships the segment range past it; a follower
  behind a compaction BASE — or one whose tip CRC diverges — is reset
  and resynced from the BASE (its stale chain, including any
  un-quorumed tail inherited from a deposed primary, is discarded
  wholesale);
- FENCING: each primary reign opens by appending a monotonically
  increasing `{"t": "epoch"}` frame and announcing the epoch on every
  link. Replicas remember the highest epoch they ever ACKed and refuse
  (reply `fenced`) anything older. A deposed primary sees `fenced` on
  its next quorum round, stops ACKing, and exits 75 — a healed
  partition can never yield two concurrently-ACKing primaries, because
  the new primary's epoch frame must itself reach quorum before the new
  primary ACKs, and any quorum overlaps any other quorum in at least
  one replica that will fence the loser.

Degradation is explicit policy, not accident: below quorum the server
either blocks admission with `ReplicaQuorumLost` + retry_after_s
(default) or — opt-in `--quorum-policy degrade` — keeps ACKing on local
fsync while loudly flagging health and metrics.

The follower side (`ReplicaServer` over a `ReplicaStore`) is a plain
directory of journal segments maintained by byte-blind application of
primary orders, so the coordinator's pool ledger — same `JobJournal`
class — replicates through the identical machinery for free.
"""

from __future__ import annotations

import os
import socket
import threading
import time

from ..chaos import sites as chaos
from ..util.backoff import DecorrelatedJitter
from .journal import JobJournal, _line_crc, _scan_lines, _unframe
from .protocol import (
    encode,
    error_obj,
    format_target,
    make_listener,
    parse_target,
    read_line,
)

#: replica-side verbs (one JSON line each way, over a PERSISTENT
#: connection — unlike the front door's one-shot `request()`):
#:   repl.hello  {epoch}                      -> {epoch, tip}
#:   repl.append {epoch, seq, prev, line}     -> ack after fsync
#:   repl.roll   {epoch, seq, header_line}    -> rolled + fresh active
#:   repl.seg    {epoch, seq, lines, active}  -> wholesale segment write
#:   repl.reset  {epoch}                      -> wipe chain (pre-resync)
#:   repl.fetch  {from_seq}                   -> {segments} (standby pull)
#:   repl.status {}                           -> {epoch, chain_epoch, tip}
REPL_VERBS = (
    "repl.hello", "repl.append", "repl.roll", "repl.seg",
    "repl.reset", "repl.fetch", "repl.status",
)

_ACTIVE = "journal.jsonl"


class ReplicaQuorumLost(RuntimeError):
    """Fewer than the configured quorum of replicas ACKed — under the
    default `block` policy the server refuses admission with this (plus
    a retry_after_s hint) instead of ACKing a frame that is durable on
    one disk only."""

    def __init__(self, msg: str, retry_after_s: float = 2.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class PrimaryFenced(RuntimeError):
    """A replica reported a higher fencing epoch: another primary has
    been promoted. This node must stop ACKing and exit 75 — its
    un-quorumed tail will be discarded when it rejoins as a follower."""

    def __init__(self, msg: str, epoch: int = 0):
        super().__init__(msg)
        self.epoch = int(epoch)


def max_epoch(records: list[dict]) -> int:
    """Highest fencing epoch in a replayed record stream (0 = none)."""
    e = 0
    for rec in records:
        if rec.get("t") == "epoch":
            e = max(e, int(rec.get("epoch", 0)))
    return e


# ---- follower side -------------------------------------------------------


class ReplicaStore:
    """A follower's journal directory: byte-blind segment chain kept
    identical to the primary's by applying its orders verbatim. Never
    parses record semantics beyond the frame CRC it inherits on disk —
    replication is a transport, the fold stays the primary's business."""

    def __init__(self, directory: str):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, _ACTIVE)
        self._lock = threading.Lock()
        self.applied = 0
        self.resyncs = 0

    # -- chain introspection ----------------------------------------------

    def _segments(self) -> list[tuple[int, str]]:
        from .journal import _SEG_RE

        out = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        out.sort()
        if os.path.exists(self.path):
            seq = out[-1][0] + 1 if out else 0
            lines = _scan_lines(self.path)
            if lines:
                first = _unframe(lines[0])
                if first is not None and first.get("t") == "seg":
                    seq = int(first.get("seq", seq))
            out.append((seq, self.path))
        return out

    def tip(self) -> dict:
        """{seq, records, crc} of the active segment as it sits on disk
        — the position the primary diffs against for catch-up."""
        segs = self._segments()
        if not segs:
            return {"seq": -1, "records": 0, "crc": 0}
        seq, path = segs[-1]
        lines = _scan_lines(path)
        n = 0
        crc = 0
        for i, line in enumerate(lines):
            rec = _unframe(line)
            if rec is None:
                break  # torn tail: position is the last whole frame
            if not (i == 0 and rec.get("t") == "seg"):
                n += 1
            crc = _line_crc(line)
        return {"seq": seq, "records": n, "crc": crc}

    def _fsync_dir(self) -> None:
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _write_durable(self, path: str, text: str, mode: str) -> None:
        with open(path, mode, encoding="utf-8") as f:
            f.write(text)
            f.flush()
            chaos.crashpoint("replica.pre-fsync-ack")
            os.fsync(f.fileno())

    # -- orders from the primary ------------------------------------------

    def apply_append(self, seq: int, prev: int, line: str) -> dict:
        """Append one raw frame iff it chains onto our tip; a position
        mismatch (we missed frames, or carry a diverged tail) asks the
        primary for a resync instead of corrupting the chain."""
        with self._lock:
            t = self.tip()
            if t["seq"] != int(seq) or t["crc"] != int(prev):
                return {"ok": False, "resync": True, "tip": t}
            self._write_durable(self.path, line + "\n", "a")
            self.applied += 1
            return {"ok": True, "crc": _line_crc(line)}

    def apply_roll(self, seq: int, header_line: str) -> dict:
        """Mirror the primary's roll: rename our active segment into the
        rolled sequence and open a fresh active holding `header_line`."""
        with self._lock:
            t = self.tip()
            if t["seq"] != int(seq) - 1:
                return {"ok": False, "resync": True, "tip": t}
            if os.path.exists(self.path):
                rolled = os.path.join(
                    self.dir, f"journal-{t['seq']:06d}.jsonl"
                )
                os.replace(self.path, rolled)
            self._write_durable(self.path, header_line + "\n", "w")
            self._fsync_dir()
            return {"ok": True, "crc": _line_crc(header_line)}

    def apply_seg(self, seq: int, lines: list[str], active: bool) -> dict:
        """Wholesale segment write (catch-up / resync): our copy of the
        segment becomes exactly these raw lines."""
        with self._lock:
            path = self.path if active else os.path.join(
                self.dir, f"journal-{int(seq):06d}.jsonl"
            )
            self._write_durable(path, "".join(l + "\n" for l in lines),
                                "w")
            self._fsync_dir()
            return {"ok": True}

    def apply_reset(self) -> dict:
        """Wipe the local chain ahead of a full resync — how a diverged
        or behind-a-BASE follower discards history (including any
        un-quorumed tail a deposed primary left us)."""
        with self._lock:
            for _, path in self._segments():
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._fsync_dir()
            self.resyncs += 1
            return {"ok": True}

    def fetch(self, from_seq: int = 0) -> dict:
        """Raw segments with seq >= from_seq — the standby's pull-sync
        and promotion read path."""
        with self._lock:
            segs = self._segments()
            out = []
            for seq, path in segs:
                if seq < int(from_seq):
                    continue
                out.append({
                    "seq": seq,
                    "active": path == self.path,
                    "lines": _scan_lines(path),
                })
            return {"ok": True, "segments": out}


class ReplicaServer:
    """The `replica` verb — a follower daemon: a `ReplicaStore` behind a
    threaded JSON-lines listener speaking the `repl.*` verbs, tracking
    the highest fencing epoch it ever accepted and refusing anything
    older (the fence half of the no-dual-primary argument)."""

    def __init__(self, directory: str, target: str):
        self.store = ReplicaStore(directory)
        self.target = str(target)
        # the fence: highest epoch ever accepted, recovered from the
        # chain itself (epoch frames are ordinary journal records)
        self.epoch = self._scan_epoch()
        self._srv = None
        self.dead = False  # set by an injected replica crash

    def _scan_epoch(self) -> int:
        e = 0
        for _, path in self.store._segments():
            for line in _scan_lines(path):
                rec = _unframe(line)
                if rec is not None and rec.get("t") == "epoch":
                    e = max(e, int(rec.get("epoch", 0)))
        return e

    def _check_epoch(self, req: dict) -> dict | None:
        e = int(req.get("epoch", 0))
        if e < self.epoch:
            return {"ok": False, "fenced": True, "epoch": self.epoch}
        self.epoch = max(self.epoch, e)
        return None

    def handle(self, req: dict) -> dict:
        verb = req.get("verb")
        try:
            if verb == "repl.status":
                # chain_epoch is the highest epoch frame ON DISK —
                # distinct from the fence (self.epoch), which a hello
                # can raise without shipping any chain bytes. Promotion
                # orders candidate chains by chain_epoch: a reign's
                # quorum-ACKed history always starts with its epoch
                # frame, so a deposed primary's stale (possibly longer)
                # tail can never outrank the newest reign's chain.
                return {"ok": True, "epoch": self.epoch,
                        "chain_epoch": self._scan_epoch(),
                        "tip": self.store.tip(), "dir": self.store.dir}
            if verb == "repl.fetch":
                out = self.store.fetch(int(req.get("from_seq", 0)))
                out["epoch"] = self.epoch
                return out
            fenced = self._check_epoch(req)
            if fenced is not None:
                return fenced
            if verb == "repl.hello":
                return {"ok": True, "epoch": self.epoch,
                        "tip": self.store.tip()}
            if verb == "repl.append":
                return self.store.apply_append(
                    int(req["seq"]), int(req["prev"]), str(req["line"])
                )
            if verb == "repl.roll":
                return self.store.apply_roll(
                    int(req["seq"]), str(req["header_line"])
                )
            if verb == "repl.seg":
                return self.store.apply_seg(
                    int(req["seq"]), list(req["lines"]),
                    bool(req.get("active")),
                )
            if verb == "repl.reset":
                return self.store.apply_reset()
            raise KeyError(f"unknown replication verb {verb!r}")
        except chaos.ChaosCrash:
            # an injected replica death: in-process trials cannot
            # SIGKILL the host process, so the replica plays dead —
            # stops listening, drops the link, never ACKs this frame
            self.die()
            raise
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, **error_obj(e)}

    def bind(self) -> str:
        if self._srv is None:
            server = self

            import socketserver

            class Handler(socketserver.StreamRequestHandler):
                def handle(self):
                    while not server.dead:
                        try:
                            req = read_line(self.rfile)
                        except ValueError:
                            return
                        if req is None:
                            return
                        try:
                            reply = server.handle(req)
                        except chaos.ChaosCrash:
                            return  # connection drops, no ack
                        try:
                            self.wfile.write(encode(reply))
                            self.wfile.flush()
                        except (BrokenPipeError, ValueError, OSError):
                            return

            self._srv, fam = make_listener(self.target, Handler)
            if fam == "tcp":
                host, port = self._srv.server_address[:2]
                self.target = f"{host}:{port}"
        return self.target

    def serve_forever(self) -> None:
        self.bind()
        self._srv.serve_forever()

    def start(self) -> str:
        """Bind + serve on a daemon thread (tests / in-process trials);
        returns the resolved target."""
        target = self.bind()
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return target

    def die(self) -> None:
        """Simulated replica host death (chaos): stop accepting, drop
        every connection. The store stays on disk for a later rebirth."""
        self.dead = True
        if self._srv is not None:
            threading.Thread(target=self._srv.shutdown,
                             daemon=True).start()

    def shutdown(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            if parse_target(self.target)[0] == "unix":
                try:
                    os.unlink(self.target)
                except OSError:
                    pass


# ---- primary side --------------------------------------------------------


class ReplicaLink:
    """One persistent connection from the primary to one replica, with
    reconnect backoff and a partition blackout window (chaos). All calls
    happen on the journal-owning thread — no locking needed."""

    def __init__(self, target: str, timeout_s: float = 5.0, rng=None):
        self.target = str(target)
        self.timeout_s = float(timeout_s)
        self._sock = None
        self._rfile = None
        self.backoff = DecorrelatedJitter(base=0.05, cap=2.0, rng=rng)
        self.retry_at = 0.0     # no reconnect attempt before this
        self.blackout_until = 0.0  # injected partition: no sends before
        self.needs_sync = True  # fresh/reconnected links resync first
        self.acks = 0
        self.failures = 0

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None
        self.needs_sync = True
        self.retry_at = time.monotonic() + self.backoff.next_delay()

    def connect(self) -> bool:
        """(Re)connect when allowed; True when a socket is up."""
        if self._sock is not None:
            return True
        now = time.monotonic()
        if now < self.retry_at or now < self.blackout_until:
            return False
        fam, addr = parse_target(self.target)
        s = socket.socket(
            socket.AF_INET6 if fam == "tcp" and ":" in addr[0]
            else socket.AF_INET if fam == "tcp"
            else socket.AF_UNIX,
            socket.SOCK_STREAM,
        )
        s.settimeout(self.timeout_s)
        try:
            s.connect(addr if fam == "tcp" else str(addr))
        except OSError:
            s.close()
            self.failures += 1
            self.retry_at = time.monotonic() + self.backoff.next_delay()
            return False
        self._sock = s
        self._rfile = s.makefile("rb")
        self.backoff.reset()
        self.needs_sync = True
        return True

    def call(self, req: dict) -> dict | None:
        """One order/ack round trip; None when the link is down (the
        frame simply did not replicate — quorum accounting's problem).
        Chaos `replicate.send` rides here: partition closes the link and
        blacks it out, duplicate delivers the frame twice (the replica's
        position check rejects the echo)."""
        if time.monotonic() < self.blackout_until:
            self._drop()
            return None
        if not self.connect():
            return None
        payload = encode(req)
        dup = False
        ev = chaos.replication("replicate.send")
        if ev is not None:
            if ev.action == "partition":
                self.blackout_until = (
                    time.monotonic() + float(ev.arg("s", 0.2))
                )
                self._drop()
                return None
            if ev.action == "duplicate":
                dup = True
        try:
            self._sock.sendall(payload)
            reply = read_line(self._rfile)
            if dup:
                # the duplicated frame draws its own reply; the replica
                # rejected it on position, which must not poison the
                # stream — drain it and keep the FIRST reply
                self._sock.sendall(payload)
                echo = read_line(self._rfile)
                if echo is not None and echo.get("resync"):
                    self.needs_sync = True
        except (OSError, ValueError):
            self.failures += 1
            self._drop()
            return None
        if reply is None:
            self.failures += 1
            self._drop()
            return None
        return reply

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None


class ReplicationSink:
    """The primary half: fans every journal mutation out to the replica
    links and accounts the quorum. Plugs into `JobJournal.sink` — the
    journal calls `on_append`/`on_roll`/`on_base` from its own write
    path, AFTER the local fsync (local durability first, then the wire).

    `quorum` counts REPLICA acks; the default `N//2 + 1` is a strict
    majority of the replicas, and any explicit quorum must satisfy
    `2K > N` — the intersection property the fencing safety argument
    stands on: two K-sized ack sets out of N replicas are guaranteed to
    share a replica ONLY when 2K > N (K=(N+1)//2 fails this for even N,
    e.g. two disjoint single-replica "quorums" at N=2), and that shared
    replica is the one that fences the deposed primary."""

    def __init__(self, journal: JobJournal, replicas: list[str],
                 quorum: int | None = None, policy: str = "block",
                 retry_after_s: float = 2.0, obs=None, rng=None,
                 node: str = "primary"):
        if policy not in ("block", "degrade"):
            raise ReplicaQuorumLost(
                f"--quorum-policy must be block|degrade, got {policy!r}"
            )
        self.journal = journal
        self.links = [ReplicaLink(t, rng=rng) for t in replicas]
        n = len(self.links)
        self.quorum = int(quorum) if quorum else n // 2 + 1
        if not 1 <= self.quorum <= n:
            raise ReplicaQuorumLost(
                f"--quorum {self.quorum} out of range 1..{n} "
                f"for {n} replica(s)"
            )
        if 2 * self.quorum <= n:
            raise ReplicaQuorumLost(
                f"--quorum {self.quorum} of {n} replica(s) does not "
                f"guarantee quorum intersection (needs 2K > N, i.e. "
                f">= {n // 2 + 1}): two disjoint ack sets could each "
                "reach quorum and a promoted standby would never fence "
                "the old primary"
            )
        self.policy = policy
        self.retry_after_s = float(retry_after_s)
        self.obs = obs
        self.node = str(node)
        self.epoch = 0
        self.fenced = False
        self.last_quorum_ok = True
        self.degraded_acks = 0
        self.quorum_losses = 0
        self.resyncs = 0

    # -- chain reading (primary's own segments, raw) -----------------------

    def _chain(self) -> list[tuple[int, str, bool]]:
        """(seq, path, active) for the primary's on-disk chain."""
        segs = [(seq, path, False)
                for seq, path in self.journal._rolled_segments()]
        if os.path.exists(self.journal.path):
            segs.append((self.journal._active_seq, self.journal.path,
                         True))
        return segs

    def _base_seq(self) -> int:
        """Seq of the newest BASE segment (0 when never compacted)."""
        base = 0
        for seq, path, _ in self._chain():
            lines = _scan_lines(path)
            if lines:
                first = _unframe(lines[0])
                if first is not None and first.get("t") == "seg" \
                        and first.get("base"):
                    base = max(base, seq)
        return base

    # -- per-link sync -----------------------------------------------------

    def _crc_at(self, seq: int, records: int) -> int | None:
        """Chained line CRC of OUR segment `seq` after `records` records
        — the value a follower whose chain is a byte-prefix of ours
        must report as its tip crc. None when we hold no such position
        (no segment with that seq, or fewer records than asked)."""
        for s, path, _ in self._chain():
            if s != int(seq):
                continue
            lines = _scan_lines(path)
            n = 0
            crc = 0
            for i, line in enumerate(lines):
                rec = _unframe(line)
                if rec is None:
                    break  # torn tail: nothing past the last whole frame
                if not (i == 0 and rec.get("t") == "seg"):
                    if n == int(records):
                        break
                    n += 1
                crc = _line_crc(line)
            return crc if n == int(records) else None
        return None

    def _sync_link(self, link: ReplicaLink) -> bool:
        """Bring one replica to our exact chain: hello for its tip, then
        re-ship whole segments from where it diverges (or reset + ship
        everything from the newest BASE when the tip is behind one or
        its bytes diverge from ours). Raw bytes only — the replica ends
        byte-identical or not at all."""
        hello = link.call({"verb": "repl.hello", "epoch": self.epoch})
        if hello is None:
            return False
        if hello.get("fenced"):
            self._fence(int(hello.get("epoch", 0)))
            return False
        tip = hello.get("tip") or {}
        chain = self._chain()
        if not chain:
            link.needs_sync = False
            return True
        base = self._base_seq()
        from_seq = int(tip.get("seq", -1))
        diverged = False
        if base <= from_seq <= chain[-1][0]:
            # the seq range alone cannot prove the follower's chain is a
            # prefix of ours: a deposed primary whose un-quorumed tail
            # crossed a roll boundary has rolled segments at the SAME
            # seqs with different bytes. Hold its tip crc to our chain
            # at the identical (segment, record) position — the tip
            # line's crc chains over the whole prefix (each roll header
            # back-links the previous segment's last line), so a match
            # certifies the prefix and a mismatch forces a full resync.
            want = self._crc_at(from_seq, int(tip.get("records", 0)))
            diverged = want is None or want != int(tip.get("crc", 0))
        if diverged or from_seq < base or from_seq > chain[-1][0]:
            # behind a compaction BASE, ahead of us entirely, or
            # byte-diverged: the follower's history is not a prefix of
            # ours — discard and resync from the BASE. This is also
            # where a deposed primary's un-quorumed tail dies on rejoin.
            if link.call({"verb": "repl.reset",
                          "epoch": self.epoch}) is None:
                return False
            from_seq = base if base else chain[0][0]
        ok = True
        for seq, path, active in chain:
            if seq < from_seq:
                continue
            r = link.call({
                "verb": "repl.seg", "epoch": self.epoch, "seq": seq,
                "lines": _scan_lines(path), "active": active,
            })
            if r is None or not r.get("ok"):
                if r is not None and r.get("fenced"):
                    self._fence(int(r.get("epoch", 0)))
                ok = False
                break
        if ok:
            link.needs_sync = False
            self.resyncs += 1
            if self.obs is not None:
                self.obs.repl_event("resync", target=link.target,
                                    from_seq=from_seq)
        return ok

    def _fence(self, epoch: int) -> None:
        if not self.fenced and self.obs is not None:
            self.obs.repl_event("fenced", epoch=epoch)
        self.fenced = True
        self.fenced_by = int(epoch)

    # -- journal seams -----------------------------------------------------

    def _ship(self, req: dict) -> int:
        """Send one order to every link (syncing stragglers first);
        returns the ack count and keeps the quorum book."""
        acks = 0
        for link in self.links:
            if self.fenced:
                break
            if link.needs_sync:
                # the sync ships our on-disk chain, which ALREADY holds
                # this order's effect (the journal seams run after the
                # local write) — the per-frame order would only bounce
                # off the replica's position check and buy a second
                # wholesale resync. A successful sync IS the ack.
                if self._sync_link(link):
                    acks += 1
                    link.acks += 1
                continue
            r = link.call(req)
            if r is None:
                continue
            if r.get("fenced"):
                self._fence(int(r.get("epoch", 0)))
                continue
            if r.get("resync"):
                # position mismatch: catch the replica up, then replay
                # this one order on the freshly-synced chain — EXCEPT
                # appends, which the sync already shipped as part of
                # the active segment's raw lines
                link.needs_sync = True
                if self._sync_link(link):
                    acks += 1
                    link.acks += 1
                continue
            if r.get("ok"):
                acks += 1
                link.acks += 1
        self.last_quorum_ok = acks >= self.quorum and not self.fenced
        if not self.last_quorum_ok:
            self.quorum_losses += 1
            if self.policy == "degrade" and not self.fenced:
                self.degraded_acks += 1
        return acks

    def on_append(self, line: str, seq: int, prev: int) -> None:
        self._ship({"verb": "repl.append", "epoch": self.epoch,
                    "seq": int(seq), "prev": int(prev), "line": line})

    def on_roll(self, seq: int, header_line: str) -> None:
        self._ship({"verb": "repl.roll", "epoch": self.epoch,
                    "seq": int(seq), "header_line": header_line})

    def on_base(self) -> None:
        """Compaction rewrote history: every follower must resync from
        the new BASE (their pre-compaction chain is no longer a prefix
        of ours)."""
        acks = 0
        for link in self.links:
            link.needs_sync = True
            if not self.fenced and self._sync_link(link):
                acks += 1
        self.last_quorum_ok = acks >= self.quorum and not self.fenced

    # -- lifecycle ---------------------------------------------------------

    def begin_epoch(self) -> int:
        """Open this primary's reign: epoch = 1 + max(own chain, every
        reachable replica), announced by appending the epoch frame as
        the first record of the reign. The frame replicates like any
        other — once it reaches quorum, every older primary's next
        quorum round meets the fence."""
        records, _ = self.journal.replay()
        e = max_epoch(records)
        for link in self.links:
            hello = link.call({"verb": "repl.status"})
            if hello is not None:
                e = max(e, int(hello.get("epoch", 0)))
        self.epoch = e + 1
        self.journal.append({
            "t": "epoch", "epoch": self.epoch, "node": self.node,
        })
        if self.obs is not None:
            self.obs.repl_event("epoch", epoch=self.epoch,
                                node=self.node)
        return self.epoch

    def heartbeat(self) -> None:
        """Idle-path quorum round (the serve loop calls this between
        ticks): reconnects and resyncs stragglers, and — crucially —
        gives a deposed primary a bounded-time path to SEEING the fence
        even when no client is writing."""
        acks = 0
        for link in self.links:
            if self.fenced:
                break
            if link.needs_sync:
                if self._sync_link(link):
                    acks += 1
                continue
            r = link.call({"verb": "repl.hello", "epoch": self.epoch})
            if r is None:
                continue
            if r.get("fenced"):
                self._fence(int(r.get("epoch", 0)))
            elif r.get("ok"):
                acks += 1
        self.last_quorum_ok = acks >= self.quorum and not self.fenced

    def quorum_ok(self) -> bool:
        return self.last_quorum_ok and not self.fenced

    def check_admission(self) -> None:
        """The server's gate, BEFORE a job id exists: under `block`,
        refuse admission while below quorum (the client gets typed
        backpressure, not a single-disk ACK)."""
        if self.fenced:
            raise PrimaryFenced(
                "this primary has been fenced by epoch "
                f"{getattr(self, 'fenced_by', 0)} (a standby promoted); "
                "resubmit to the new primary", getattr(self, "fenced_by", 0),
            )
        if self.policy == "block" and not self.last_quorum_ok:
            raise ReplicaQuorumLost(
                f"replication quorum lost ({self.quorum} ack(s) "
                f"required from {len(self.links)} replica(s))",
                self.retry_after_s,
            )

    def status(self) -> dict:
        return {
            "replicas": [
                {"target": l.target, "connected": l.connected,
                 "acks": l.acks, "failures": l.failures,
                 "needs_sync": l.needs_sync}
                for l in self.links
            ],
            "quorum": self.quorum,
            "policy": self.policy,
            "epoch": self.epoch,
            "fenced": self.fenced,
            "quorum_ok": self.quorum_ok(),
            "degraded_acks": self.degraded_acks,
            "quorum_losses": self.quorum_losses,
            "resyncs": self.resyncs,
        }

    def close(self) -> None:
        for link in self.links:
            link.close()


# ---- standby / promotion -------------------------------------------------


def _repl_call(target: str, req: dict, timeout_s: float = 5.0) -> dict:
    """One-shot repl.* round trip (standby pull path; no persistence)."""
    link = ReplicaLink(target, timeout_s=timeout_s)
    try:
        r = link.call(req)
    finally:
        link.close()
    if r is None:
        raise ConnectionError(
            f"replica at {format_target(target)} unreachable"
        )
    return r


def pull_chain(replicas: list[str], dest_dir: str) -> dict:
    """Copy the best reachable replica chain into `dest_dir` verbatim
    (wiping whatever chain sat there — a stale standby tail is exactly
    the history a promotion must discard). Candidates are ordered by
    (chain epoch, seq, records): EPOCH FIRST, because a deposed
    primary's replica-local un-quorumed tail can be LONGER than the new
    reign's quorum-ACKed chain — adopting it by length alone would
    silently discard quorum-ACKed jobs (invariant A). Every reign's
    chain opens with its epoch frame, so the highest chain epoch marks
    the replica that holds the newest reign's history; length only
    breaks ties within one reign, where chains are linear prefixes of
    each other. Returns {source, epoch, tip, reachable}; raises
    ReplicaQuorumLost when no replica answers."""
    best = None
    reachable = 0
    for t in replicas:
        try:
            st = _repl_call(t, {"verb": "repl.status"})
        except (ConnectionError, OSError):
            continue
        reachable += 1
        tip = st.get("tip") or {}
        key = (int(st.get("chain_epoch", 0)),
               int(tip.get("seq", -1)), int(tip.get("records", 0)))
        if best is None or key > best[0]:
            best = (key, t, st)
    if best is None:
        raise ReplicaQuorumLost(
            f"no replica reachable out of {len(replicas)}", 5.0
        )
    _, src, st = best
    fetched = _repl_call(src, {"verb": "repl.fetch", "from_seq": 0})
    store = ReplicaStore(dest_dir)
    store.apply_reset()
    for seg in fetched.get("segments", []):
        store.apply_seg(int(seg["seq"]), list(seg["lines"]),
                        bool(seg.get("active")))
    return {"source": src, "epoch": int(fetched.get("epoch", 0)),
            "tip": store.tip(), "reachable": reachable}


class Standby:
    """`serve --standby-of PRIMARY`: tail a follower while the
    primary lives, promote when it stays dead past the grace window.

    Promotion = pull the best (highest-epoch) reachable replica chain into our own
    state dir, then start serving with a fresh fencing epoch — the
    epoch frame's quorum commit is what actually deposes the old
    primary; until it lands, the standby is not a primary."""

    def __init__(self, primary: str, replicas: list[str], state_dir: str,
                 grace_s: float = 3.0, poll_s: float = 0.5, rng=None,
                 min_reachable: int | None = None):
        self.primary = str(primary)
        self.replicas = list(replicas)
        self.state_dir = str(state_dir)
        self.grace_s = float(grace_s)
        self.poll_s = float(poll_s)
        self.rng = rng
        n = len(self.replicas)
        # same 2K > N majority as the sink's quorum: a minority-
        # partition standby must not elect itself
        self.min_reachable = (
            int(min_reachable) if min_reachable else n // 2 + 1
        )
        self.last_sync: dict | None = None

    def wait_for_takeover(self, max_wait_s: float | None = None) -> dict:
        """Block until the primary has been dead for the grace window,
        keeping our state dir warm with periodic pull-syncs; returns the
        final pull report. Raises TimeoutError when `max_wait_s` passes
        with the primary still alive."""
        from .protocol import socket_alive

        jit = DecorrelatedJitter(base=self.poll_s,
                                 cap=max(4 * self.poll_s, 2.0),
                                 rng=self.rng)
        dead_since = None
        t0 = time.monotonic()
        while True:
            if socket_alive(self.primary):
                dead_since = None
                jit.reset()
                try:
                    self.last_sync = pull_chain(self.replicas,
                                                self.state_dir)
                except (ReplicaQuorumLost, ConnectionError, OSError):
                    pass  # replicas flapping; primary is alive anyway
            else:
                now = time.monotonic()
                dead_since = dead_since or now
                if now - dead_since >= self.grace_s:
                    return self.promote_pull()
            if max_wait_s is not None \
                    and time.monotonic() - t0 > max_wait_s:
                raise TimeoutError(
                    f"primary {self.primary} still alive after "
                    f"{max_wait_s}s of standby watch"
                )
            time.sleep(jit.next_delay())

    def promote_pull(self) -> dict:
        """The final pre-promotion pull: require a quorum's worth of
        reachable replicas (a minority view must not elect itself), then
        adopt the highest-epoch chain."""
        report = pull_chain(self.replicas, self.state_dir)
        if report["reachable"] < self.min_reachable:
            raise ReplicaQuorumLost(
                f"only {report['reachable']} replica(s) reachable; "
                f"promotion needs {self.min_reachable}", 5.0,
            )
        return report
