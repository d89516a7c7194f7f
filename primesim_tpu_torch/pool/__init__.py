"""primesim_tpu_torch.pool — elastic worker pool for multi-process sweeps,
the JAX package's `pool/` for the port.

`python -m primesim_tpu_torch sweep --workers N` decomposes a sweep into per-element work
units and leases them to N independent worker processes over the serve
wire protocol. Leases expire when heartbeats stop (crash/OOM-kill), the
unit re-dispatches and resumes from its last element checkpoint; a unit
that kills `poison_threshold` distinct workers is quarantined as poison;
near campaign end the coordinator hedges stragglers (first-ACK-wins).
The lease ledger is a serve `JobJournal`, so `kill -9`ing the
coordinator and restarting with the same --pool-dir replays the campaign
without re-simulating any committed chunk. See DESIGN.md §17 and README
"Elastic sweeps". The workers are `python -m primesim_tpu_torch worker`
processes; each resolves its device once, at its first simulated unit
(the card unless it was given `--device cpu`), and several share one
card.

Unit/ledger helpers import eagerly; the coordinator, worker, and
campaign runner (which pull in torch and the fleet) resolve lazily so
`import primesim_tpu_torch.pool` stays cheap for protocol-only callers.
"""

from .units import (
    DEFAULT_POISON_THRESHOLD,
    DONE,
    LEASED,
    PENDING,
    POISON,
    SUSPECT,
    build_units,
    fold_unit_records,
    unit_key,
)

_LAZY = {
    "PoolCoordinator": "coordinator",
    "PoolWorker": "worker",
    "LeaseLost": "worker",
    "SimulatedCrash": "worker",
    "run_worker": "worker",
    "run_pooled_sweep": "campaign",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = [
    "DEFAULT_POISON_THRESHOLD",
    "DONE",
    "LEASED",
    "LeaseLost",
    "PENDING",
    "POISON",
    "SUSPECT",
    "PoolCoordinator",
    "PoolWorker",
    "SimulatedCrash",
    "build_units",
    "fold_unit_records",
    "run_pooled_sweep",
    "run_worker",
    "unit_key",
]
