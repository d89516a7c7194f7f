"""Digests of a finished run, to hold a full-width run against a reference.

A full-width machine keeps megabytes of results, too much to commit. A
digest keeps what a run is judged by: the step count, the retired
instructions, the largest core clock, the sha256 of the per-core cycles
and of the 26 per-core counters (each as int64, in `COUNTER_NAMES`
order), every counter's sum, and the sha256 of the final NoC link clocks
and DRAM controller clocks (int32, epoch-relative as the state holds
them). The inputs are numpy arrays, so the same function digests a run of
the port and a run of the JAX package.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .counters import COUNTER_NAMES


def sha256(*arrays, dtype=np.int64) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype).tobytes())
    return h.hexdigest()


def run_digest(steps, cycles, counters, link_free, dram_free) -> dict:
    cycles = np.asarray(cycles, np.int64)
    return {
        "steps": int(steps),
        "instructions": int(np.sum(counters["instructions"], dtype=np.int64)),
        "max_core_cycles": int(cycles.max()),
        "cycles_sha256": sha256(cycles),
        "counters_sha256": sha256(*(counters[k] for k in COUNTER_NAMES)),
        "counter_sums": {
            k: int(np.sum(counters[k], dtype=np.int64)) for k in COUNTER_NAMES
        },
        "link_free_sha256": sha256(link_free, dtype=np.int32),
        "dram_free_sha256": sha256(dram_free, dtype=np.int32),
    }
