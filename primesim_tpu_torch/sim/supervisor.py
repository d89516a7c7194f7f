"""Per-element fault isolation for a fleet: the JAX package's
`sim/supervisor.py::validate_fleet_element` and `build_fleet_isolated`
for the port.

A sweep's element whose trace file is unreadable or malformed, or whose
overrides are invalid, is quarantined while the rest of the batch runs.
The JAX module's supervisor proper (checkpointed chunk commits, guards,
preemption) is not ported yet.
"""

from __future__ import annotations

from ..trace.format import validate_sync


def validate_fleet_element(cfg, trace, override: dict | None = None) -> None:
    """Everything FleetEngine.__init__ would reject about ONE element,
    checked in isolation: override keys/values, core count, addressing
    line size, barrier ids vs the slot table. Raises ValueError (often
    the located TraceError subclass)."""
    from .fleet import apply_overrides

    apply_overrides(cfg, override or {})
    if trace.n_cores != cfg.n_cores:
        raise ValueError(f"trace has {trace.n_cores} cores, config {cfg.n_cores}")
    if trace.line_addressed:
        trace.line_events(cfg.line_bits)  # line-size validation only
    validate_sync(trace, cfg.barrier_slots)


def build_fleet_isolated(
    cfg,
    sources: list,
    overrides: list[dict] | None = None,
    chunk_steps: int = 256,
    device=None,
):
    """Build a FleetEngine from per-element sources with fault isolation.

    `sources[i]` is a Trace or a zero-arg callable returning one (pass
    callables for file loads so an unreadable/corrupt FILE quarantines
    its element instead of killing the batch). Elements whose load or
    validation fails are dropped; the survivors' batch positions map
    back to caller indices through `fleet.element_ids`.

    Returns `(fleet, quarantined)` where `quarantined` is a list of
    `(original_index, exception)` and `fleet` is None when nothing
    survived."""
    from .fleet import FleetEngine

    sources = list(sources)
    if overrides is None:
        overrides = [{}] * len(sources)
    overrides = list(overrides)
    if len(overrides) != len(sources):
        raise ValueError(
            f"got {len(sources)} trace sources but {len(overrides)} "
            "override dicts (must match 1:1)"
        )
    kept, kept_ovs, ids = [], [], []
    quarantined: list[tuple[int, Exception]] = []
    for i, (src, ov) in enumerate(zip(sources, overrides)):
        try:
            trace = src() if callable(src) else src
            validate_fleet_element(cfg, trace, ov)
        except (ValueError, OSError) as e:
            quarantined.append((i, e))
            continue
        kept.append(trace)
        kept_ovs.append(ov)
        ids.append(i)
    if not kept:
        return None, quarantined
    fleet = FleetEngine(cfg, kept, kept_ovs, chunk_steps=chunk_steps, device=device)
    fleet.element_ids = ids
    return fleet, quarantined
