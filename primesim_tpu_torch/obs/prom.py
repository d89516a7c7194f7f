"""Prometheus text-exposition renderer for the serve daemon.

Pure formatting over the scheduler's live state — no collection happens
here (the scheduler/journal already maintain the counters and
histograms), so rendering is safe to call from the tick loop at any
time. Output follows the text exposition format version 0.0.4:
``# HELP`` / ``# TYPE`` headers, histograms as cumulative ``_bucket``
series with an explicit ``+Inf`` bucket plus ``_sum``/``_count``.

The JAX package's `obs/prom.py`, copied whole for the port (it touches no
device), so the two packages' daemons, clients and state directories
speak one protocol and one journal format.
"""

from __future__ import annotations

import time


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        return repr(v)
    return str(v)


class _Doc:
    def __init__(self):
        self.lines = []

    def metric(self, name, mtype, help_text, samples):
        """samples: list of (labels_dict_or_None, value)."""
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if labels:
                lab = ",".join(
                    f'{k}="{v}"' for k, v in labels.items()
                )
                self.lines.append(f"{name}{{{lab}}} {_fmt(value)}")
            else:
                self.lines.append(f"{name} {_fmt(value)}")

    def histogram(self, name, help_text, hist):
        snap = hist.snapshot()
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} histogram")
        for bound, cum in zip(snap["bounds"], snap["cumulative"]):
            self.lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        self.lines.append(f'{name}_bucket{{le="+Inf"}} {snap["count"]}')
        self.lines.append(f"{name}_sum {_fmt(snap['sum'])}")
        self.lines.append(f"{name}_count {snap['count']}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_prometheus(sched, journal=None, draining=False,
                      recovered=None, quota=None, repl=None) -> str:
    """Render the daemon's scrape payload from a live Scheduler (and
    optionally its JobJournal + the server's recovery/drain state)."""
    s = sched.stats()
    d = _Doc()

    d.metric("primetpu_queue_depth", "gauge",
             "Jobs pending in the bounded admission queue.",
             [(None, s["queue_depth"])])
    d.metric("primetpu_slots", "gauge",
             "Fleet slots by bucket and occupancy.",
             [({"pages": str(b["pages"]), "state": "occupied"},
               b["occupied"]) for b in s["slots"]["buckets"]]
             + [({"pages": str(b["pages"]), "state": "free"},
                 b["slots"] - b["occupied"])
                for b in s["slots"]["buckets"]])
    d.metric("primetpu_slots_total", "gauge",
             "Total fleet slots across all buckets.",
             [(None, s["slots"]["total"])])
    d.metric("primetpu_slots_occupied", "gauge",
             "Occupied fleet slots across all buckets.",
             [(None, s["slots"]["occupied"])])
    d.metric("primetpu_jobs", "gauge",
             "Jobs in the table by lifecycle state.",
             [({"state": st}, n) for st, n in sorted(s["jobs"].items())])
    d.metric("primetpu_jobs_completed_total", "counter",
             "Jobs retired DONE since daemon start.",
             [(None, s["completed"])])
    d.metric("primetpu_instructions_total", "counter",
             "Simulated instructions retired across all completed jobs.",
             [(None, sched.total_instructions)])
    d.metric("primetpu_aggregate_mips", "gauge",
             "Simulated MIPS aggregated over daemon uptime.",
             [(None, s["aggregate_mips"])])
    d.metric("primetpu_uptime_seconds", "gauge",
             "Seconds since daemon start.",
             [(None, s["uptime_s"])])
    d.metric("primetpu_draining", "gauge",
             "1 while the daemon is draining for shutdown.",
             [(None, 1 if draining else 0)])
    d.metric("primetpu_promotions_total", "counter",
             "Windowed jobs migrated UP to a larger capacity bucket "
             "before reaching the window edge (v2 paged allocator).",
             [(None, getattr(sched, "promotions", 0))])
    d.metric("primetpu_demotions_total", "counter",
             "Jobs migrated DOWN to a smaller bucket to unblock a "
             "queued job that only fits the larger one.",
             [(None, getattr(sched, "demotions", 0))])
    d.metric("primetpu_quota_rejections_total", "counter",
             "Submits rejected by per-tenant admission quotas.",
             [(None, quota.rejections if quota is not None else 0)])
    workers = (s.get("workers") or {})
    if workers:
        d.metric("primetpu_dispatch_workers", "gauge",
                 "Live pool-worker processes owned by this front-end "
                 "(dispatch mode).",
                 [({"state": "live"}, workers.get("live", 0)),
                  ({"state": "max"}, workers.get("max", 0))])
        d.metric("primetpu_dispatch_coordinator_adopted", "gauge",
                 "1 when this front-end ADOPTED a live coordinator "
                 "instead of spawning one (standby takeover).",
                 [(None, 1 if workers.get("coordinator_adopted") else 0)])

    last_t = getattr(sched, "last_dispatch_t", None)
    age = (time.time() - last_t) if last_t else float("nan")
    d.metric("primetpu_last_dispatch_age_seconds", "gauge",
             "Seconds since a job was last placed into a slot "
             "(NaN before the first dispatch).",
             [(None, age)])

    hist = getattr(sched, "latency_hist", None)
    if hist is not None:
        d.histogram("primetpu_job_latency_seconds",
                    "Accept-to-terminal latency of finished jobs.", hist)

    if journal is not None:
        d.metric("primetpu_journal_appends_total", "counter",
                 "Journal records fsynced since daemon start.",
                 [(None, journal.appended)])
        fsync = getattr(journal, "fsync_hist", None)
        if fsync is not None:
            d.histogram("primetpu_journal_fsync_seconds",
                        "Wall time of each journal write+flush+fsync.",
                        fsync)

    if repl is not None:
        rs = repl.status()
        d.metric("primetpu_replication_links", "gauge",
                 "Replica links by connection state.",
                 [({"state": "connected"},
                   sum(1 for r in rs["replicas"] if r["connected"])),
                  ({"state": "configured"}, len(rs["replicas"]))])
        d.metric("primetpu_replication_quorum_ok", "gauge",
                 "1 while the last quorum round reached the configured "
                 "replica-ack quorum (0 = degraded or blocking).",
                 [(None, 1 if rs["quorum_ok"] else 0)])
        d.metric("primetpu_replication_epoch", "gauge",
                 "Fencing epoch of this primary's reign.",
                 [(None, rs["epoch"])])
        d.metric("primetpu_replication_fenced", "gauge",
                 "1 once a higher epoch deposed this primary "
                 "(it stops ACKing and exits 75).",
                 [(None, 1 if rs["fenced"] else 0)])
        d.metric("primetpu_replication_degraded_acks_total", "counter",
                 "Appends ACKed on local fsync only while below quorum "
                 "(--quorum-policy degrade).",
                 [(None, rs["degraded_acks"])])
        d.metric("primetpu_replication_quorum_losses_total", "counter",
                 "Quorum rounds that fell short of the required "
                 "replica acks.", [(None, rs["quorum_losses"])])
        d.metric("primetpu_replication_resyncs_total", "counter",
                 "Follower catch-up resyncs pushed by this primary.",
                 [(None, rs["resyncs"])])

    if recovered:
        d.metric("primetpu_recovered_jobs", "gauge",
                 "Jobs recovered from the journal at startup.",
                 [({"kind": "replayed"},
                   recovered.get("jobs_replayed", 0)),
                  ({"kind": "requeued"},
                   recovered.get("jobs_requeued", 0))])

    return d.render()


def render_pool_prometheus(coord) -> str:
    """Scrape payload for a live pool coordinator (`metrics` verb on the
    pool socket — `primetpu serve-status --metrics` works against it)."""
    s = coord.stats()
    d = _Doc()

    d.metric("primetpu_pool_units", "gauge",
             "Work units by lease-lifecycle state.",
             [({"state": st}, n) for st, n in sorted(s["units"].items())])
    d.metric("primetpu_pool_leases_active", "gauge",
             "Leases currently held by workers (hedges count twice).",
             [(None, s["leases_active"])])
    d.metric("primetpu_pool_workers_seen", "gauge",
             "Distinct worker ids that have ever requested a lease.",
             [(None, len(s["workers_seen"]))])
    c = s["counters"]
    d.metric("primetpu_pool_leases_total", "counter",
             "Leases granted since campaign start.",
             [(None, c["leases"])])
    d.metric("primetpu_pool_expired_total", "counter",
             "Leases expired for missed heartbeats (presumed-dead "
             "workers).", [(None, c["expired"])])
    d.metric("primetpu_pool_redispatches_total", "counter",
             "Units re-dispatched after a lease expiry.",
             [(None, c["redispatches"])])
    d.metric("primetpu_pool_hedges_total", "counter",
             "Speculative straggler re-dispatches (first-ACK-wins).",
             [(None, c["hedges"])])
    d.metric("primetpu_pool_acks_total", "counter",
             "Unit results accepted.", [(None, c["acks"])])
    d.metric("primetpu_pool_duplicate_acks_total", "counter",
             "Acks discarded because another attempt already won.",
             [(None, c["duplicates"])])
    d.metric("primetpu_pool_poisoned_total", "counter",
             "Units quarantined after killing distinct workers.",
             [(None, c["poisoned"])])
    d.metric("primetpu_pool_heartbeats_total", "counter",
             "Heartbeats received.", [(None, c["heartbeats"])])
    d.metric("primetpu_pool_readoptions_total", "counter",
             "Live worker leases re-adopted by heartbeat epoch after a "
             "coordinator restart (failover without re-simulation).",
             [(None, c.get("readoptions", 0))])
    d.metric("primetpu_pool_enqueued_total", "counter",
             "Work units accepted via the dynamic enqueue verb.",
             [(None, c.get("enqueued", 0))])
    rec = s.get("recovered") or {}
    if rec:
        d.metric("primetpu_pool_recovered", "gauge",
                 "Ledger replay results from the last coordinator start.",
                 [({"kind": "units_respawned"},
                   rec.get("units_respawned", 0)),
                  ({"kind": "results_adopted"},
                   rec.get("results_adopted", 0))])
    d.metric("primetpu_pool_done", "gauge",
             "1 when every unit is DONE or POISON.",
             [(None, 1 if s["done"] else 0)])

    journal = getattr(coord, "journal", None)
    if journal is not None:
        d.metric("primetpu_journal_appends_total", "counter",
                 "Ledger records fsynced since campaign start.",
                 [(None, journal.appended)])
        fsync = getattr(journal, "fsync_hist", None)
        if fsync is not None:
            d.histogram("primetpu_journal_fsync_seconds",
                        "Wall time of each ledger write+flush+fsync.",
                        fsync)

    return d.render()
