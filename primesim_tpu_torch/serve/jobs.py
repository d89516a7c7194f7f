"""Job records and the slot-lifecycle state machine (DESIGN.md §14).

A job is one (trace, config-override, deadline, priority) simulation
request. Its lifecycle:

    PENDING ──admit──> RUNNING ──finish──> DONE
       │                  │
       │                  ├─ wall deadline ──> TIMEOUT
       │                  ├─ step budget / poisoned ──> QUARANTINED
       │                  ├─ retryable failure ──(re-enqueue)──> PENDING
       │                  └─ exhausted retries ──> FAILED
       ├─ wall deadline ──> TIMEOUT
       ├─ unloadable/invalid workload ──> QUARANTINED
       └─ client cancel ──> CANCELLED   (also from RUNNING)

Terminal states are sticky; every transition is journaled
(serve/journal.py) so a `kill -9` at any instant loses no accepted job.
The workload is stored as a SPEC (trace path or synth spec), not as
event bytes: specs are deterministic to re-materialize, which is what
makes journal replay bit-exact.

The JAX package's `serve/jobs.py`, copied whole for the port (it touches no
device), so the two packages' daemons, clients and state directories
speak one protocol and one journal format.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

# non-terminal
PENDING = "PENDING"
RUNNING = "RUNNING"
# terminal
DONE = "DONE"
FAILED = "FAILED"
TIMEOUT = "TIMEOUT"
QUARANTINED = "QUARANTINED"
CANCELLED = "CANCELLED"

TERMINAL_STATES = (DONE, FAILED, TIMEOUT, QUARANTINED, CANCELLED)
STATES = (PENDING, RUNNING) + TERMINAL_STATES

_LEGAL = {
    PENDING: {RUNNING, TIMEOUT, QUARANTINED, CANCELLED},
    RUNNING: {PENDING, DONE, FAILED, TIMEOUT, QUARANTINED, CANCELLED},
}


@dataclass
class Job:
    """One accepted simulation request. `trace_path`/`synth` is the
    workload spec (exactly one set); `overrides` are fleet timing-knob
    overrides (sim.fleet.KNOB_KEYS); `deadline_s` is a WALL-clock budget
    measured from acceptance (None = none); `max_steps` the step budget."""

    job_id: str
    client: str = "anon"
    trace_path: str | None = None
    synth: str | None = None
    overrides: dict = field(default_factory=dict)
    fold: bool = True
    deadline_s: float | None = None
    max_steps: int = 10_000_000
    priority: int = 0
    accepted_t: float = field(default_factory=time.time)
    # client-supplied idempotency token: a retried submit after a lost
    # ACK presents the same token and is answered with THIS job instead
    # of double-enqueueing (journaled, so dedup survives restart)
    idem: str | None = None
    # mutable progress (not part of the accept record)
    state: str = PENDING
    detail: dict = field(default_factory=dict)
    result: dict | None = None
    attempts: int = 0
    finished_t: float | None = None
    # host-only (never journaled): materialized workload + supervision
    _trace: object = None
    _elem_cfg: object = None
    _ctx: object = None
    _resume_from: str | None = None
    # v2 paged allocator: the truncated WINDOW trace currently spliced
    # into a small bucket (None = the full trace is resident), plus a
    # cached has-sync flag (sync events pin a trace to full residency)
    _window: object = None
    _has_sync: bool | None = None

    # ---- state machine ---------------------------------------------------

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def transition(self, new: str, detail: dict | None = None) -> None:
        if new not in STATES:
            raise ValueError(f"unknown job state {new!r}")
        if self.terminal or new not in _LEGAL[self.state]:
            raise ValueError(
                f"illegal job transition {self.state} -> {new} ({self.job_id})"
            )
        self.state = new
        if detail:
            self.detail = dict(detail)
        if new in TERMINAL_STATES:
            self.finished_t = time.time()

    def deadline_expired(self, now: float | None = None) -> bool:
        if self.deadline_s is None:
            return False
        return (now if now is not None else time.time()) \
            >= self.accepted_t + self.deadline_s

    @property
    def latency_s(self) -> float | None:
        """Accept-to-terminal wall latency (None while in flight)."""
        if self.finished_t is None:
            return None
        return self.finished_t - self.accepted_t

    # ---- journal (de)serialization --------------------------------------

    def accept_record(self) -> dict:
        """The immutable acceptance facts — everything needed to re-run
        the job from scratch after a crash."""
        return {
            "job_id": self.job_id,
            "client": self.client,
            "trace_path": self.trace_path,
            "synth": self.synth,
            "overrides": dict(self.overrides),
            "fold": self.fold,
            "deadline_s": self.deadline_s,
            "max_steps": self.max_steps,
            "priority": self.priority,
            "accepted_t": self.accepted_t,
            "idem": self.idem,
        }

    @classmethod
    def from_accept_record(cls, rec: dict) -> "Job":
        keys = {f.name for f in dataclasses.fields(cls)
                if not f.name.startswith("_")}
        return cls(**{k: v for k, v in rec.items() if k in keys})

    def public(self) -> dict:
        """The client-visible job view (STATUS replies, health detail)."""
        out = {
            "job_id": self.job_id,
            "client": self.client,
            "state": self.state,
            "priority": self.priority,
            "attempts": self.attempts,
            "accepted_t": self.accepted_t,
        }
        if self.detail:
            out["detail"] = self.detail
        if self.latency_s is not None:
            out["latency_s"] = round(self.latency_s, 3)
        if self.result is not None:
            out["result"] = self.result
        return out
