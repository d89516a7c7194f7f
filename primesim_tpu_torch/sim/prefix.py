"""Identical-element detection for a fleet: the JAX package's
`sim/prefix.py::dedup_plan` for the port.

Two elements with the same trace and the same effective config simulate
the same run, so a sweep simulates the first and reports it for both.
The JAX module's prefix forking (`plan_prefix`, `execute_prefix_plan`)
and warm-state cache are not ported yet.
"""

from __future__ import annotations

from .checkpoint import trace_fingerprint

__all__ = ["dedup_plan", "trace_fingerprint"]


def dedup_plan(elem_cfgs: list, traces: list) -> tuple[list[int], dict[int, int]]:
    """Identical-element detection: positions whose (trace, effective
    config) pair equals an earlier element's simulate nothing new.
    Returns (kept_indices, dup_of) where dup_of maps each duplicate
    position to the earlier position whose results it shares."""
    seen: dict = {}
    keep: list[int] = []
    dup_of: dict[int, int] = {}
    for i, (cfg, tr) in enumerate(zip(elem_cfgs, traces)):
        sig = (trace_fingerprint(tr), cfg.to_json())
        if sig in seen:
            dup_of[i] = seen[sig]
        else:
            seen[sig] = i
            keep.append(i)
    return keep, dup_of
