"""Deterministic chaos for the simulator's own infrastructure
(DESIGN.md §20), the JAX package's `chaos/` for the port.

`faults/` injects faults into the simulated machine; this package
injects faults into the machinery that runs the simulation (journals,
checkpoints, sockets, process lifetimes, committed host values):

- `plan`     — `FaultPlan`: a seeded, JSON-serializable schedule of
               fault events keyed by site name + occurrence index, so
               any failing trial is a one-line repro.
- `sites`    — the fault-site registry threaded through the real I/O
               paths (journal append, checkpoint replace, protocol
               send/recv, named crashpoints, silent corruption, device
               revocation, the disk-space probe). With no plan installed
               every hook is one branch and the stack stays bit-exact.
- `campaign` — seeded trial runner + invariant checks + plan shrinker
               behind the `chaos` CLI verb.

`PRIMETPU_CHAOS_PLAN=<plan.json>` (and `PRIMETPU_CHAOS_MODE=kill|raise`)
installs a plan in any CLI process: `cli.main` calls `install_from_env`
first.
"""

from .plan import FaultEvent, FaultPlan
from .sites import (
    SITES,
    ChaosCrash,
    active,
    crashpoint,
    deactivate,
    install,
    install_from_env,
)

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "SITES",
    "ChaosCrash",
    "active",
    "crashpoint",
    "deactivate",
    "install",
    "install_from_env",
]
