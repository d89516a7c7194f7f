"""primesim_tpu_torch.serve — the crash-safe continuous-batching
simulation service, the JAX package's `serve/` for the port, in its
local mode.

`python -m primesim_tpu_torch serve` owns one fleet per capacity bucket
on its device and splices client jobs into free slots as elements
retire; every accepted job is journaled (WAL) and checkpointed so a
`kill -9` loses nothing. See DESIGN.md §14. The daemon, its clients, its
journal and its element checkpoints are the JAX package's formats, so
either package's client talks to either daemon and a state directory
written by one replays in the other.

Light modules (jobs, journal, protocol, quota, client) import eagerly;
the scheduler and server (which pull in torch and the fleet) resolve
lazily so `import primesim_tpu_torch.serve` stays cheap for clients.
Not ported yet: the replicated journal (`replicate.py`) and dispatch to
a worker pool (`dispatch.py`).
"""

from .client import ServeClient, ServeError
from .jobs import (
    CANCELLED,
    DONE,
    FAILED,
    PENDING,
    QUARANTINED,
    RUNNING,
    TERMINAL_STATES,
    TIMEOUT,
    Job,
)
from .journal import JobJournal, JournalCorrupt, fold_records
from .protocol import error_obj

_LAZY = {
    "Scheduler": "scheduler",
    "SlotBucket": "scheduler",
    "QueueFull": "scheduler",
    "DEFAULT_BUCKETS": "scheduler",
    "PAGE_EVENTS": "scheduler",
    "materialize_workload": "scheduler",
    "PrimeServer": "server",
    "EX_TEMPFAIL": "server",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = [
    "CANCELLED",
    "DEFAULT_BUCKETS",
    "DONE",
    "EX_TEMPFAIL",
    "FAILED",
    "Job",
    "JobJournal",
    "JournalCorrupt",
    "PAGE_EVENTS",
    "PENDING",
    "PrimeServer",
    "QUARANTINED",
    "QueueFull",
    "RUNNING",
    "Scheduler",
    "ServeClient",
    "ServeError",
    "SlotBucket",
    "TERMINAL_STATES",
    "TIMEOUT",
    "error_obj",
    "fold_records",
    "materialize_workload",
]
