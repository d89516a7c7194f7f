"""Pool coordinator — lease-based work distribution (DESIGN.md §17): the
JAX package's `pool/coordinator.py` for the port. Its replies and ledger
records are the JAX coordinator's, so either package's coordinator
replays a pool directory the other wrote, and either package's workers
could lease from it.

The coordinator owns the campaign: a table of work units, a durable
ledger (the serve `JobJournal` reused verbatim), and a unix socket
speaking the same JSON-lines protocol as `serve`. Workers are peers that
PULL:

    lease      {worker}                      -> {unit, epoch, checkpoint?}
                                              | {idle, retry_after_s}
                                              | {done: true}
    heartbeat  {worker, unit_id, epoch, steps} -> {ok} | {lost: true}
    ack        {worker, unit_id, epoch, key, result, resumed_steps}
                                             -> {accepted} | {duplicate}
    status     {}                            -> campaign stats
    metrics    {}                            -> Prometheus text

Lease discipline: a grant carries an `epoch` (monotonic per unit) and a
deadline `lease_ttl_s` ahead; heartbeats renew it. A worker that stops
heartbeating — crashed, OOM-killed, wedged — has its lease EXPIRE, which
journals the kill evidence and returns the unit to PENDING for
re-dispatch, where the next worker resumes from the unit's last element
checkpoint. Expiry is the only failure detector: the coordinator never
watches pids, so workers may live anywhere the socket reaches.

Safety: a unit whose leases expired under `poison_threshold` DISTINCT
workers is quarantined as poison (it is killing whoever touches it) and
the campaign proceeds without it. Liveness: first-ACK-wins — an ack is
accepted even from an expired epoch, because units are deterministic, so
a "lost" worker that was merely slow still contributes its result.

Hedging: when PENDING runs dry but leases remain in flight, a lease
request is answered with a SPECULATIVE twin of the oldest single-leased
unit (epoch bumped). First ack wins; the loser's ack is RETAINED in the
ledger (`ack_dup`, full payload) rather than discarded.

Attestation (`attest="chain"`, DESIGN.md §24): ack records carry the
worker's per-chunk fingerprint chain head, and the coordinator CHECKS
rather than discards every duplicate — a hedged twin whose chain
disagrees with the winner's voids the result, holds both payloads, and
re-runs the unit fresh on a third worker as tiebreaker; whichever held
worker the tiebreak refutes is quarantined (refused all future leases)
under the SUSPECT state, distinct from poison. Lease grants also verify
the worker's toolchain fields (the port's: torch, CUDA, backend and the
kernels' source key, `attest.chain.toolchain_fingerprint`) so a
wrong-toolchain worker is refused before computing anything, and
`audit_rate=p` re-dispatches a deterministic fraction of DONE units to a
different worker for sampled re-execution audit.
"""

from __future__ import annotations

import os
import socketserver
import threading
import time

from ..chaos import sites as chaos
from ..serve.journal import JobJournal
from ..serve.protocol import (
    encode,
    error_obj,
    make_listener,
    parse_target,
    read_line,
)
from . import units as U


class PoolCoordinator:
    def __init__(
        self,
        units: list[dict],
        pool_dir: str,
        socket_path: str | None = None,
        lease_ttl_s: float = 10.0,
        poison_threshold: int = U.DEFAULT_POISON_THRESHOLD,
        hedge: bool = True,
        obs=None,
        clock=time.monotonic,
        dynamic: bool = False,
        attest: str = "off",
        audit_rate: float = 0.0,
    ):
        self.pool_dir = str(pool_dir)
        os.makedirs(os.path.join(self.pool_dir, "units"), exist_ok=True)
        self.socket_path = socket_path or os.path.join(
            self.pool_dir, "pool.sock"
        )
        self.lease_ttl_s = float(lease_ttl_s)
        self.poison_threshold = int(poison_threshold)
        self.hedge_enabled = bool(hedge)
        # dynamic mode (the elastic front-end, DESIGN.md §18): units
        # arrive via the `enqueue` verb instead of a fixed campaign, the
        # ledger stores their specs (`unit` records), and `done` never
        # trips — idle workers wait (or --idle-exit) instead of exiting
        self.dynamic = bool(dynamic)
        self.obs = obs
        # chaos clock-skew site wraps the lease/expiry clock; with no
        # plan active this returns `clock` itself (zero overhead)
        self.clock = chaos.wrap_clock("coordinator.clock", clock)
        # segmentation + compaction keep the pool ledger bounded across
        # long services; pool_compactor preserves fold_unit_records
        self.journal = JobJournal(self.pool_dir,
                                  compactor=U.pool_compactor)
        self.journal.obs = obs

        self._lock = threading.Lock()
        # unit_id -> mutable coordinator state wrapped around the spec
        self.units: dict[str, dict] = {}
        for spec in units:
            self.units[spec["unit_id"]] = self._entry(spec)
        self.workers_seen: set[str] = set()
        self.counters = {
            "leases": 0, "expired": 0, "redispatches": 0, "hedges": 0,
            "acks": 0, "duplicates": 0, "poisoned": 0, "heartbeats": 0,
            "readoptions": 0, "enqueued": 0,
            # attestation (DESIGN.md §24)
            "attest_confirms": 0, "attest_mismatches": 0,
            "attest_incomparable": 0, "suspects": 0, "verdicts": 0,
            "audits": 0, "audits_ok": 0, "toolchain_refused": 0,
            # degraded-mode elasticity (DESIGN.md §26): acks whose lease
            # ran on a smaller mesh than requested after device loss
            "capacity_degraded": 0,
        }
        if attest not in ("off", "chain"):
            from ..attest import AttestationError
            raise AttestationError(
                f"attest must be off|chain, got {attest!r}",
                site="coordinator.init",
            )
        self.attest_mode = str(attest)
        self.audit_rate = float(audit_rate)
        # workers a tiebreak refuted: refused every future lease
        self.suspect_workers: set[str] = set()
        # unit_id -> sampled re-execution audit bookkeeping
        self.audits: dict[str, dict] = {}
        self._toolchain = None  # lazy reference triple (attest on only)
        # per-client round-robin bookkeeping for the QoS lease pick
        self._last_pick: dict[str, int] = {}
        self._pick_n = 0
        self.recovered = self._recover()
        self._srv = None
        if self.attest_mode != "off" and not self.dynamic:
            # an offline audit replays units from the ledger alone —
            # journal each classic-campaign spec once so a kill -9'd pool
            # dir is self-describing (dynamic mode already journals specs
            # at enqueue)
            for uid, u in self.units.items():
                if uid not in self._spec_journaled:
                    self.journal.append({"t": "unit", "unit": u["spec"]})
                    self._spec_journaled.add(uid)

    @staticmethod
    def _entry(spec: dict) -> dict:
        return {
            "spec": spec,
            "state": U.PENDING,
            "epoch": 0,
            # worker -> {epoch, deadline, granted, steps, hedge}
            "leases": {},
            "kills": set(),
            "result": None,
            "resumed_steps": 0,
            # attestation (§24): the authoritative ack's chain payload
            # and worker, payloads held across a divergence, and workers
            # barred from re-running THIS unit (the divergent pair)
            "attest": None,
            "ack_worker": None,
            "held": [],
            "suspects": set(),
        }

    # ---- restart recovery ------------------------------------------------

    def _recover(self) -> dict:
        """Replay the pool ledger: adopt journaled results (matching unit
        key only — a changed campaign definition must not inherit stale
        results), poison marks, and kill evidence. Unfinished units go
        back to PENDING; their in-flight workers re-adopt their leases on
        the next heartbeat (see `_h_heartbeat`)."""
        records, dropped = self.journal.replay()
        # first pass: re-create dynamically enqueued units from their
        # journaled specs (a kill -9'd coordinator has no campaign list
        # to hand back in — the ledger IS the unit table), remember which
        # specs are already on record, and re-adopt worker quarantines
        respawned = 0
        self._spec_journaled: set[str] = set()
        for rec in records:
            t = rec.get("t")
            if t == "verdict":
                self.suspect_workers |= {
                    str(w) for w in rec.get("quarantined", [])}
                continue
            if t != "unit":
                continue
            spec = rec.get("unit") or {}
            uid = str(spec.get("unit_id", ""))
            if uid:
                self._spec_journaled.add(uid)
            if uid and uid not in self.units:
                self.units[uid] = self._entry(spec)
                respawned += 1
        folded, clean = U.fold_unit_records(records)
        adopted = stale = 0
        for unit_id, f in folded.items():
            u = self.units.get(unit_id)
            if u is None:
                stale += 1
                continue
            if f["key"] is not None and f["key"] != u["spec"]["key"]:
                stale += 1  # ledger describes a different campaign
                continue
            u["epoch"] = max(u["epoch"], f["max_epoch"])
            u["kills"] |= f["kills"]
            u["suspects"] |= f["suspects"]
            u["held"] = list(f["held"])
            if f["result"] is not None:
                u["state"] = U.DONE
                u["result"] = f["result"]
                u["resumed_steps"] = f["resumed_steps"]
                u["attest"] = f["attest"]
                u["ack_worker"] = f["ack_worker"]
                adopted += 1
                if self._audit_due(u) and not f["audits"]:
                    # the sample decision is a pure function of the unit
                    # key, so a restart re-derives exactly the audits
                    # that had not yet completed
                    self.audits[unit_id] = {
                        "state": "pending", "worker": None, "epoch": 0,
                        "orig": str(f["ack_worker"] or ""),
                        "deadline": 0.0, "tried": set(),
                    }
            elif f["suspect"] == "terminal":
                u["state"] = U.SUSPECT
            elif f["poison"]:
                u["state"] = U.POISON
            # f["suspect"] == "pending" stays PENDING: the tiebreak
            # re-dispatch survives a coordinator restart via u["held"]
        stats = {
            "ledger_records": len(records),
            "torn_tail_dropped": dropped,
            "results_adopted": adopted,
            "stale_entries": stale,
            "units_respawned": respawned,
            "clean_drain": clean,
        }
        if records:
            self.journal.note(f"pool recovered: {stats}")
        return stats

    # ---- lease bookkeeping (call with self._lock held) -------------------

    def _expire_stale(self) -> None:
        now = self.clock()
        for unit_id, u in self.units.items():
            if u["state"] != U.LEASED:
                continue
            for worker in [w for w, l in u["leases"].items()
                           if l["deadline"] < now]:
                lease = u["leases"].pop(worker)
                u["kills"].add(worker)
                self.counters["expired"] += 1
                self.journal.append({
                    "t": "expire", "unit_id": unit_id, "worker": worker,
                    "epoch": lease["epoch"],
                })
                self._pool_event("expire", unit=unit_id, worker=worker,
                                 epoch=lease["epoch"])
            if not u["leases"]:
                if len(u["kills"]) >= self.poison_threshold:
                    u["state"] = U.POISON
                    self.counters["poisoned"] += 1
                    self.journal.append({
                        "t": "poison", "unit_id": unit_id,
                        "key": u["spec"]["key"],
                        "kills": sorted(u["kills"]),
                    })
                    self._pool_event("poison", unit=unit_id,
                                     kills=len(u["kills"]))
                else:
                    u["state"] = U.PENDING  # re-dispatch on next lease
        for unit_id, a in self.audits.items():
            if a["state"] == "leased" and a["deadline"] < now:
                # audit worker went quiet: back to pending, and let the
                # same worker retry later (liveness over strictness)
                a["tried"].discard(a["worker"])
                a["state"] = "pending"
                a["worker"] = None

    def _checkpoint_rel(self, unit_id: str) -> str | None:
        rel = os.path.join("units", f"{unit_id}.npz")
        if os.path.exists(os.path.join(self.pool_dir, rel)):
            return rel
        return None

    def _grant(self, u: dict, worker: str, hedge: bool) -> dict:
        unit_id = u["spec"]["unit_id"]
        u["epoch"] += 1
        u["state"] = U.LEASED
        redispatch = bool(u["kills"]) and not hedge
        u["leases"][worker] = {
            "epoch": u["epoch"],
            "deadline": self.clock() + self.lease_ttl_s,
            "granted": self.clock(),
            "steps": 0,
            "hedge": hedge,
        }
        self.counters["leases"] += 1
        if hedge:
            self.counters["hedges"] += 1
        if redispatch:
            self.counters["redispatches"] += 1
        self.journal.append({
            "t": "lease", "unit_id": unit_id, "worker": worker,
            "epoch": u["epoch"], "key": u["spec"]["key"],
            "hedge": hedge,
        })
        # lease journaled, grant not yet delivered: the restart must
        # re-adopt or expire this lease, never lose the unit
        chaos.crashpoint("coordinator.post-lease")
        self._pool_event(
            "hedge" if hedge else ("redispatch" if redispatch else "lease"),
            unit=unit_id, worker=worker, epoch=u["epoch"],
        )
        grant = {
            "ok": True,
            "unit": u["spec"],
            "epoch": u["epoch"],
            "lease_ttl_s": self.lease_ttl_s,
            "checkpoint": self._checkpoint_rel(unit_id),
            "pool_dir": self.pool_dir,
            "hedge": hedge,
        }
        if self.attest_mode != "off":
            grant["attest"] = self.attest_mode
        if u["held"]:
            # tiebreak re-run after a divergence: no checkpoint resume,
            # no warm fork — the third chain must be comparable to both
            # held chains, and a held worker's checkpoint could carry
            # the very corruption under adjudication
            grant["fresh"] = True
            grant["checkpoint"] = None
        return grant

    def _hedge_candidate(self, worker: str) -> dict | None:
        """Oldest single-leased in-flight unit not already held by this
        worker — the straggler most worth a speculative twin."""
        best = None
        for u in self.units.values():
            if u["state"] != U.LEASED or worker in u["leases"]:
                continue
            if len(u["leases"]) != 1:
                continue  # one hedge twin at a time
            granted = min(l["granted"] for l in u["leases"].values())
            if best is None or granted < best[0]:
                best = (granted, u)
        return best[1] if best else None

    # ---- verb handlers ---------------------------------------------------

    def handle(self, req: dict) -> dict:
        verb = req.get("verb")
        try:
            if verb == "metrics":
                # rendered OUTSIDE the lock: render_pool_prometheus
                # calls stats(), which takes it (non-reentrant)
                from ..obs.prom import render_pool_prometheus

                return {
                    "ok": True,
                    "content_type": "text/plain; version=0.0.4",
                    "text": render_pool_prometheus(self),
                }
            if (verb == "lease" and self.attest_mode != "off"
                    and self._toolchain is None):
                # outside the lock: the first fingerprint imports torch,
                # which must not stall the other verbs (enqueue, collect,
                # heartbeats) on a loaded host
                from ..attest import toolchain_fingerprint

                self._toolchain = toolchain_fingerprint()
            with self._lock:
                if verb == "lease":
                    return self._h_lease(req)
                if verb == "heartbeat":
                    return self._h_heartbeat(req)
                if verb == "ack":
                    return self._h_ack(req)
                if verb == "enqueue":
                    return self._h_enqueue(req)
                if verb == "collect":
                    return self._h_collect(req)
                if verb == "status":
                    return {"ok": True, **self._stats()}
                raise ValueError(f"unknown verb {verb!r}")
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, **error_obj(e)}

    def _h_lease(self, req: dict) -> dict:
        worker = str(req.get("worker", "anon"))
        self.workers_seen.add(worker)
        self._expire_stale()
        if self.attest_mode != "off":
            refused = self._verify_worker(worker, req)
            if refused is not None:
                return refused
        pending = [u for u in self.units.values()
                   if u["state"] == U.PENDING
                   and worker not in u["suspects"]]
        if pending:
            u = min(pending, key=self._pick_key)
            self._pick_n += 1
            self._last_pick[
                str(u["spec"].get("client", "anon"))
            ] = self._pick_n
            return self._grant(u, worker, hedge=False)
        audit = self._audit_candidate(worker)
        if audit is not None:
            return self._grant_audit(audit, worker)
        if self.done:
            return {"ok": True, "done": True}
        if self.hedge_enabled:
            u = self._hedge_candidate(worker)
            if u is not None:
                return self._grant(u, worker, hedge=True)
        return {"ok": True, "idle": True,
                "retry_after_s": max(0.2, self.lease_ttl_s / 5.0)}

    def _verify_worker(self, worker: str, req: dict) -> dict | None:
        """Attested lease admission: quarantined workers and workers on
        a different toolchain are refused BEFORE they compute anything.
        Returns the refusal reply, or None to proceed."""
        from ..attest import AttestationError, toolchain_matches

        if worker in self.suspect_workers:
            e = AttestationError(
                f"worker {worker!r} is quarantined as SUSPECT (a "
                "tiebreak refuted its attested result)",
                site="coordinator.lease", unit="")
            return {"ok": False, "refused": "suspect", **error_obj(e)}
        tc = req.get("toolchain")
        if tc is not None:
            if self._toolchain is None:
                from ..attest import toolchain_fingerprint

                self._toolchain = toolchain_fingerprint()
            field = toolchain_matches(self._toolchain, tc)
            if field:
                self.counters["toolchain_refused"] += 1
                self._pool_event("toolchain_refused", worker=worker,
                                 field=field)
                e = AttestationError(
                    f"worker {worker!r} toolchain mismatch on "
                    f"{field!r}: coordinator "
                    f"{self._toolchain.get(field)!r} vs worker "
                    f"{tc.get(field)!r} — results would not be "
                    "comparable (toolchain fields)",
                    site="coordinator.lease", unit="")
                return {"ok": False, "refused": "toolchain",
                        **error_obj(e)}
        return None

    # ---- sampled re-execution audit (attest on, DESIGN.md §24) ----------

    def _audit_due(self, u: dict) -> bool:
        if (self.audit_rate <= 0 or self.attest_mode == "off"
                or u["spec"].get("kind") == "ingest"):
            return False
        if self.audit_rate >= 1.0:
            return True
        import hashlib

        blob = f"{u['spec']['key']}:{u['spec']['unit_id']}:audit"
        frac = int(hashlib.sha256(blob.encode()).hexdigest()[:8], 16)
        return frac / 0xFFFFFFFF < self.audit_rate

    def _audit_candidate(self, worker: str) -> str | None:
        """A pending audit this worker may serve: a DIFFERENT worker
        than the original acker, preferably. When the campaign is
        otherwise complete and nobody else will ever ask, a self-audit
        beats hanging the campaign (it still catches nondeterministic
        corruption, not a systematically-wrong worker)."""
        if not self.audits:
            return None
        live = any(u["state"] in (U.PENDING, U.LEASED)
                   for u in self.units.values())
        fallback = None
        for unit_id, a in self.audits.items():
            u = self.units.get(unit_id)
            if (a["state"] != "pending" or u is None
                    or u["state"] != U.DONE or worker in a["tried"]):
                continue
            if worker != a["orig"]:
                return unit_id
            if not live:
                fallback = fallback or unit_id
        return fallback

    def _grant_audit(self, unit_id: str, worker: str) -> dict:
        u = self.units[unit_id]
        a = self.audits[unit_id]
        u["epoch"] += 1
        a.update(state="leased", worker=worker, epoch=u["epoch"],
                 deadline=self.clock() + self.lease_ttl_s)
        a["tried"].add(worker)
        self.counters["audits"] += 1
        self.journal.append({
            "t": "lease", "unit_id": unit_id, "worker": worker,
            "epoch": u["epoch"], "key": u["spec"]["key"],
            "hedge": False, "audit": True,
        })
        self._pool_event("audit", unit=unit_id, worker=worker,
                         epoch=u["epoch"])
        return {
            "ok": True,
            "unit": u["spec"],
            "epoch": u["epoch"],
            "lease_ttl_s": self.lease_ttl_s,
            "checkpoint": None,
            "pool_dir": self.pool_dir,
            "hedge": False,
            "audit": True,
            "fresh": True,
            "attest": self.attest_mode,
        }

    def _pick_key(self, u: dict):
        """Lease pick order = the serve scheduler's QoS tiers carried
        through dispatch: priority first, then least-recently-served
        client (fairness under one chatty tenant), then campaign index
        (classic sweeps have neither and keep their index order)."""
        spec = u["spec"]
        return (
            -int(spec.get("priority", 0)),
            self._last_pick.get(str(spec.get("client", "anon")), 0),
            int(spec.get("index", 0)),
        )

    def _h_heartbeat(self, req: dict) -> dict:
        worker = str(req.get("worker", "anon"))
        unit_id = str(req.get("unit_id", ""))
        epoch = int(req.get("epoch", 0))
        self.counters["heartbeats"] += 1
        u = self.units.get(unit_id)
        a = self.audits.get(unit_id)
        if (a is not None and a["state"] == "leased"
                and a["worker"] == worker and a["epoch"] == epoch):
            a["deadline"] = self.clock() + self.lease_ttl_s
            return {"ok": True, "lease_ttl_s": self.lease_ttl_s}
        if u is None or u["state"] in (U.DONE, U.POISON, U.SUSPECT):
            return {"ok": True, "lost": True}
        lease = u["leases"].get(worker)
        if lease is None and u["state"] == U.PENDING and epoch == u["epoch"]:
            # graceful coordinator restart: the worker outlived us and is
            # still simulating the current epoch — re-adopt its lease
            # rather than wastefully re-dispatching the unit
            u["state"] = U.LEASED
            lease = u["leases"][worker] = {
                "epoch": epoch, "granted": self.clock(),
                "deadline": 0.0, "steps": 0, "hedge": False,
            }
            self.workers_seen.add(worker)
            self.counters["readoptions"] += 1
            self._pool_event("readopt", unit=unit_id, worker=worker,
                             epoch=epoch)
        if lease is None or lease["epoch"] != epoch:
            return {"ok": True, "lost": True}  # expired or superseded
        lease["deadline"] = self.clock() + self.lease_ttl_s
        lease["steps"] = int(req.get("steps", lease["steps"]))
        self._pool_event("heartbeat", unit=unit_id, worker=worker,
                         epoch=epoch, steps=lease["steps"])
        return {"ok": True, "lease_ttl_s": self.lease_ttl_s}

    def _h_ack(self, req: dict) -> dict:
        worker = str(req.get("worker", "anon"))
        unit_id = str(req.get("unit_id", ""))
        epoch = int(req.get("epoch", 0))
        u = self.units.get(unit_id)
        if u is None:
            raise KeyError(f"unknown unit {unit_id!r}")
        if str(req.get("key", "")) != u["spec"]["key"]:
            raise ValueError(
                f"{unit_id}: ack key mismatch (campaign changed under "
                "the worker?)"
            )
        if u["state"] in (U.DONE, U.SUSPECT):
            # the losing half of a hedged pair, an audit re-execution, or
            # a redelivery after a lost ack reply. First ACK already won
            # the result — but the loser's chain is evidence, not waste:
            # journal it and compare heads (DESIGN.md §24)
            return self._h_ack_dup(u, req, worker, epoch)
        if u["held"]:
            # third execution after an attested divergence: adjudicate
            return self._h_tiebreak(u, req, worker, epoch)
        # first-ACK-wins: accept even from an expired epoch — the unit is
        # deterministic, a slow-but-alive "lost" worker's result is the
        # same result
        result = req.get("result")
        resumed = int(req.get("resumed_steps", 0))
        attest = req.get("attest") if self.attest_mode != "off" else None
        rec = {
            "t": "ack", "unit_id": unit_id, "worker": worker,
            "epoch": epoch, "key": u["spec"]["key"], "result": result,
            "resumed_steps": resumed,
        }
        if attest:
            rec["attest"] = attest
        self.journal.append(rec)
        # result durable, worker not yet told: a crash here must replay
        # to DONE and fold the worker's re-ack away as a duplicate
        chaos.crashpoint("coordinator.post-ack")
        u["state"] = U.DONE
        u["result"] = result
        u["resumed_steps"] = resumed
        u["attest"] = attest
        u["ack_worker"] = worker
        u["leases"].clear()
        self.counters["acks"] += 1
        self._pool_event("ack", unit=unit_id, worker=worker, epoch=epoch,
                         resumed_steps=resumed)
        granted = (result or {}).get("detail", {}).get("devices_granted")
        if granted:
            # the worker re-leased onto a shrunken mesh (device loss):
            # book the capacity change durably so a replayed coordinator
            # and the campaign report both carry it
            self.counters["capacity_degraded"] += 1
            self.journal.append({
                "t": "note", "kind": "capacity", "unit_id": unit_id,
                "worker": worker,
                "devices_requested": int(
                    (result or {}).get("detail", {}).get("devices", 0)
                ),
                "devices_granted": int(granted),
            })
            self._pool_event("capacity_degraded", unit=unit_id,
                             worker=worker, devices_granted=int(granted))
        if (not req.get("audit") and unit_id not in self.audits
                and self._audit_due(u)):
            self.audits[unit_id] = {
                "state": "pending", "orig": worker, "worker": None,
                "epoch": 0, "deadline": 0.0, "tried": set(),
            }
        # unit checkpoint is dead weight once the result is durable
        rel = self._checkpoint_rel(unit_id)
        if rel:
            try:
                os.unlink(os.path.join(self.pool_dir, rel))
            except OSError:
                pass
        return {"ok": True, "accepted": True}

    def _h_ack_dup(self, u: dict, req: dict, worker: str,
                   epoch: int) -> dict:
        """A second execution's ack for an already-terminal unit. The
        legacy path dropped these on the floor; with attestation the
        loser's chain head is the cheapest integrity check we will ever
        get — a full independent re-execution that already happened."""
        unit_id = u["spec"]["unit_id"]
        attest = req.get("attest") if self.attest_mode != "off" else None
        is_audit = bool(req.get("audit"))
        rec = {
            "t": "ack_dup", "unit_id": unit_id, "worker": worker,
            "epoch": epoch, "key": u["spec"]["key"],
            "result": req.get("result"),
            "resumed_steps": int(req.get("resumed_steps", 0)),
        }
        if attest:
            rec["attest"] = attest
        if is_audit:
            rec["audit"] = True
        self.journal.append(rec)
        self.counters["duplicates"] += 1
        a = self.audits.get(unit_id)
        audit_closing = (is_audit and a is not None
                         and a.get("worker") == worker)
        if u["state"] == U.SUSPECT or u["attest"] is None or not attest:
            # terminal-suspect unit, attest off, or a chainless twin:
            # nothing to compare, the record alone is the retention win
            if audit_closing:
                a["state"] = "done"
            self._pool_event("duplicate", unit=unit_id, worker=worker,
                             epoch=epoch)
            return {"ok": True, "accepted": False, "duplicate": True}
        from ..attest import chain as _chain

        if not _chain.comparable(u["attest"], attest):
            # warm-forked / OOM-halved cadence: equally valid, not
            # comparable — count it, never suspect it
            self.counters["attest_incomparable"] += 1
            if audit_closing:
                a["state"] = "done"
                self.journal.append({"t": "audit", "unit_id": unit_id,
                                     "worker": worker, "ok": None})
            self._pool_event("duplicate", unit=unit_id, worker=worker,
                             epoch=epoch)
            return {"ok": True, "accepted": False, "duplicate": True}
        if _chain.heads_equal(u["attest"], attest):
            self.counters["attest_confirms"] += 1
            if audit_closing:
                a["state"] = "done"
                self.counters["audits_ok"] += 1
                self.journal.append({"t": "audit", "unit_id": unit_id,
                                     "worker": worker, "ok": True})
                self._pool_event("audit_ok", unit=unit_id, worker=worker)
            self._pool_event("attest_confirm", unit=unit_id,
                             worker=worker, epoch=epoch)
            return {"ok": True, "accepted": False, "duplicate": True}
        return self._attest_mismatch(u, req, worker, epoch, attest)

    def _attest_mismatch(self, u: dict, req: dict, worker: str,
                         epoch: int, attest: dict) -> dict:
        """Two comparable chains disagree: neither result can be
        trusted (first-ack-wins picked a winner by latency, not by
        correctness). Hold BOTH payloads, void the unit back to PENDING
        for a third execution on a different worker, and bar both
        claimants from picking it back up."""
        unit_id = u["spec"]["unit_id"]
        self.counters["attest_mismatches"] += 1
        held = [
            {"worker": u["ack_worker"], "result": u["result"],
             "resumed_steps": u["resumed_steps"], "attest": u["attest"]},
            {"worker": worker, "result": req.get("result"),
             "resumed_steps": int(req.get("resumed_steps", 0)),
             "attest": attest},
        ]
        workers = sorted({str(h["worker"]) for h in held})
        self.journal.append({
            "t": "suspect", "unit_id": unit_id, "key": u["spec"]["key"],
            "workers": workers, "held": held,
        })
        chaos.crashpoint("coordinator.post-ack")
        u["state"] = U.PENDING
        u["result"] = None
        u["resumed_steps"] = 0
        u["attest"] = None
        u["ack_worker"] = None
        u["held"] = held
        u["suspects"] |= set(workers)
        u["leases"].clear()
        self.audits.pop(unit_id, None)
        # either claimant may have rewritten the unit checkpoint after
        # the first ack — it is evidence-tainted, force fresh runs
        rel = self._checkpoint_rel(unit_id)
        if rel:
            try:
                os.unlink(os.path.join(self.pool_dir, rel))
            except OSError:
                pass
        self._pool_event("suspect", unit=unit_id, workers=workers)
        return {"ok": True, "accepted": False, "duplicate": True,
                "mismatch": True}

    def _h_tiebreak(self, u: dict, req: dict, worker: str,
                    epoch: int) -> dict:
        """Third execution's verdict on a held divergence: whichever
        held chain it reproduces was right, the other worker is
        quarantined as SUSPECT. No match -> the unit itself is SUSPECT
        (terminal, unresolved) and all three chains are preserved."""
        from ..attest import chain as _chain

        unit_id = u["spec"]["unit_id"]
        attest = req.get("attest") if self.attest_mode != "off" else None
        third = {"worker": worker, "result": req.get("result"),
                 "resumed_steps": int(req.get("resumed_steps", 0)),
                 "attest": attest}
        match = None
        if attest:
            for h in u["held"]:
                if (_chain.comparable(h["attest"], attest)
                        and _chain.heads_equal(h["attest"], attest)):
                    match = h
                    break
        self.counters["verdicts"] += 1
        if match is not None:
            quarantined = sorted(
                str(h["worker"]) for h in u["held"] if h is not match)
            self.journal.append({
                "t": "verdict", "unit_id": unit_id,
                "key": u["spec"]["key"], "outcome": "resolved",
                "worker": worker, "epoch": epoch,
                "result": req.get("result"),
                "resumed_steps": third["resumed_steps"],
                "attest": attest, "quarantined": quarantined,
                "confirmed": str(match["worker"]),
            })
            chaos.crashpoint("coordinator.post-ack")
            u["state"] = U.DONE
            u["result"] = req.get("result")
            u["resumed_steps"] = third["resumed_steps"]
            u["attest"] = attest
            u["ack_worker"] = worker
            u["held"] = []
            u["leases"].clear()
            self.counters["acks"] += 1
            for w in quarantined:
                if w not in self.suspect_workers:
                    self.suspect_workers.add(w)
                    self.counters["suspects"] += 1
                    self._pool_event("suspect_quarantine", worker=w,
                                     unit=unit_id)
            rel = self._checkpoint_rel(unit_id)
            if rel:
                try:
                    os.unlink(os.path.join(self.pool_dir, rel))
                except OSError:
                    pass
            self._pool_event("verdict", unit=unit_id, worker=worker,
                             outcome="resolved")
            return {"ok": True, "accepted": True}
        # three executions, three stories (or the tiebreak came back
        # chainless): nobody can be trusted, keep all the evidence
        held = u["held"] + [third]
        self.journal.append({
            "t": "verdict", "unit_id": unit_id, "key": u["spec"]["key"],
            "outcome": "unresolved", "held": held,
        })
        chaos.crashpoint("coordinator.post-ack")
        u["state"] = U.SUSPECT
        u["held"] = held
        u["leases"].clear()
        self._pool_event("verdict", unit=unit_id, worker=worker,
                         outcome="unresolved")
        return {"ok": True, "accepted": False, "suspect": True}

    def _h_enqueue(self, req: dict) -> dict:
        """Dynamic-mode admission (the elastic front-end's dispatch
        path). Idempotent by (unit_id, key): re-enqueueing after a
        front-end restart replies the unit's CURRENT state — including
        its result when a worker finished it while the front-end was
        down — instead of double-scheduling the work."""
        spec = dict(req.get("unit") or {})
        unit_id = str(spec.get("unit_id", ""))
        if not unit_id:
            raise ValueError("enqueue: unit spec has no unit_id")
        if spec.get("synth") is None and spec.get("trace_path") is None:
            raise ValueError(f"enqueue {unit_id}: no synth or trace_path")
        if not spec.get("config"):
            raise ValueError(f"enqueue {unit_id}: no config")
        spec.setdefault("key", U.unit_key(spec))
        u = self.units.get(unit_id)
        if u is not None:
            if u["spec"]["key"] != spec["key"]:
                raise ValueError(
                    f"enqueue {unit_id}: key mismatch with the already-"
                    "enqueued spec (same id, different workload)"
                )
            return {"ok": True, "unit_id": unit_id, "state": u["state"],
                    "result": u["result"],
                    "resumed_steps": u["resumed_steps"],
                    "duplicate": True}
        self.journal.append({"t": "unit", "unit": spec})
        self.units[unit_id] = self._entry(spec)
        self.counters["enqueued"] += 1
        self._pool_event("enqueue", unit=unit_id,
                         client=spec.get("client", "anon"))
        return {"ok": True, "unit_id": unit_id, "state": U.PENDING,
                "result": None, "resumed_steps": 0, "duplicate": False}

    def _h_collect(self, req: dict) -> dict:
        """Outcomes for the requested unit ids (the front-end polls this
        to map worker results back onto serve jobs): terminal units in
        `finished`, currently-leased ids in `leased` (the front-end's
        PENDING -> RUNNING signal)."""
        want = req.get("unit_ids")
        finished, leased = [], []
        for unit_id in (want if want is not None else self.units):
            u = self.units.get(str(unit_id))
            if u is None:
                continue
            if u["state"] == U.LEASED:
                leased.append(u["spec"]["unit_id"])
            elif u["state"] in (U.DONE, U.POISON, U.SUSPECT):
                finished.append({
                    "unit_id": u["spec"]["unit_id"],
                    "state": u["state"],
                    "result": u["result"],
                    "resumed_steps": u["resumed_steps"],
                    "kills": sorted(u["kills"]),
                    "suspects": sorted(u["suspects"]),
                })
        return {"ok": True, "finished": finished, "leased": leased}

    # ---- campaign state --------------------------------------------------

    @property
    def done(self) -> bool:
        if self.dynamic:
            return False  # a service is never "done"; workers idle-wait
        if not all(u["state"] in (U.DONE, U.POISON, U.SUSPECT)
                   for u in self.units.values()):
            return False
        # open audits hold the campaign: a sampled re-execution that
        # never runs is a sampled re-execution that never detects
        return all(a["state"] == "done" for a in self.audits.values())

    def results(self) -> list[dict]:
        """Per-unit outcomes in index order (poisoned units carry
        result=None plus their kill evidence)."""
        out = []
        for u in sorted(self.units.values(),
                        key=lambda u: u["spec"]["index"]):
            out.append({
                "unit_id": u["spec"]["unit_id"],
                "index": u["spec"]["index"],
                "state": u["state"],
                "result": u["result"],
                "resumed_steps": u["resumed_steps"],
                "kills": sorted(u["kills"]),
                "suspects": sorted(u["suspects"]),
            })
        return out

    def _stats(self) -> dict:
        states = {s: 0 for s in (U.PENDING, U.LEASED, U.DONE, U.POISON,
                                 U.SUSPECT)}
        leases_active = 0
        for u in self.units.values():
            states[u["state"]] += 1
            leases_active += len(u["leases"])
        return {
            "units": states,
            "leases_active": leases_active,
            "workers_seen": sorted(self.workers_seen),
            "counters": dict(self.counters),
            "recovered": self.recovered,
            "done": self.done,
        }

    def stats(self) -> dict:
        with self._lock:
            return self._stats()

    def pool_report(self) -> dict:
        """POOL section payload for stats.report.render_report."""
        s = self.stats()
        return {
            "units_total": len(self.units),
            "units_done": s["units"][U.DONE],
            "units_poisoned": s["units"][U.POISON],
            "units_suspect": s["units"][U.SUSPECT],
            "workers_seen": len(s["workers_seen"]),
            "redispatches": s["counters"]["redispatches"],
            "expired_leases": s["counters"]["expired"],
            "hedges": s["counters"]["hedges"],
            "duplicate_acks": s["counters"]["duplicates"],
            "heartbeats": s["counters"]["heartbeats"],
            "attest_confirms": s["counters"]["attest_confirms"],
            "attest_mismatches": s["counters"]["attest_mismatches"],
            "audits": s["counters"]["audits"],
            "suspect_workers": s["counters"]["suspects"],
        }

    def _pool_event(self, kind: str, **args) -> None:
        if self.obs is not None:
            self.obs.pool_event(kind, **args)

    # ---- socket front door -----------------------------------------------

    def start(self):
        """Bind the pool socket and serve verbs from daemon threads.
        Handlers take self._lock per request, so no inbox/main-loop dance
        is needed — the coordinator never simulates, it only bookkeeps."""
        coord = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = read_line(self.rfile)
                    except ValueError as e:
                        self.wfile.write(encode({"ok": False,
                                                 **error_obj(e)}))
                        return
                    if req is None:
                        return
                    try:
                        self.wfile.write(encode(coord.handle(req)))
                        self.wfile.flush()
                    except (BrokenPipeError, ValueError):
                        return

        self._srv, fam = make_listener(self.socket_path, Handler)
        if fam == "tcp" and parse_target(self.socket_path)[1][1] == 0:
            # port 0 = kernel-assigned: rewrite the target so status
            # lines and spawned workers see the real port
            host, port = self._srv.server_address[:2]
            self.socket_path = f"{host}:{port}"
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        return self._srv

    def tick(self) -> None:
        """Periodic housekeeping from the campaign loop: expire leases
        whose heartbeats stopped."""
        with self._lock:
            self._expire_stale()

    def close(self, drained: bool = False) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if parse_target(self.socket_path)[0] == "unix":
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        if drained:
            self.journal.drain()
        self.journal.close()
