"""Canonical stat counters (DESIGN.md §3).

Replaces the reference's scattered per-model counters + report fields
(SURVEY.md §2 #12). Every counter is tracked PER CORE (attributed to the
requesting core for uncore events) so the report can show both per-core and
aggregate numbers like the reference's text report.

Both engines carry these as arrays `[n_cores]`; the JAX engine uses int32 on
device and drains into an int64 host-side accumulator at chunk boundaries.
"""

from __future__ import annotations

import numpy as np

COUNTER_NAMES = (
    "instructions",    # INS batch counts + 1 per retired memory op
    "l1_read_hits",
    "l1_read_misses",  # GETS issued
    "l1_write_hits",   # write hit in E/M (incl. silent E->M)
    "l1_write_misses", # GETM issued
    "upgrades",        # ST hit in S -> UPG issued
    "llc_hits",
    "llc_misses",
    "dram_accesses",
    "l1_writebacks",   # M victim evicted from L1
    "llc_writebacks",  # owned victim evicted from LLC
    "probes",          # owner probes sent
    "invalidations",   # invalidation messages sent (sharer + back-inv)
    "noc_msgs",
    "noc_hops",
    "retries",         # conflict-serialization retries (lost (bank,set) race)
    "lock_acquires",   # LOCK events retired
    "lock_spins",      # failed LOCK attempts (charged spin round trips)
    "barrier_waits",   # BARRIER arrivals
    "noc_contention_cycles",  # router-occupancy queueing cycles charged
    "dram_queue_cycles",  # memory-controller queueing waits (dram_queue)
    # ---- fault injection (DESIGN.md §12; zero with faults disabled) ----
    "noc_reroutes",    # one-way messages detoured around a dead link
    "ecc_corrected",   # single-bit flips corrected in-line by SECDED
    "ecc_due",         # detected-uncorrectable (double-bit) errors
    "core_failstops",  # cores fail-stopped (scheduled or DUE-escalated)
    # ---- machine zoo (DESIGN.md §25; zero with prefetcher "none") ------
    "prefetch_hits",   # LLC misses served by the stride prefetcher
)


def zero_counters(n_cores: int, dtype=np.int64) -> dict[str, np.ndarray]:
    return {k: np.zeros(n_cores, dtype=dtype) for k in COUNTER_NAMES}
