"""Fault plans — the seeded, serializable schedule of what breaks when:
the JAX package's `chaos/plan.py` for the port, unchanged, so a plan file
either package writes replays in the other.

A `FaultPlan` is derived from a single integer seed: `generate(seed)`
expands it into a list of `FaultEvent`s, each keyed by a registered
SITE NAME (chaos.sites.SITES) and a 1-based OCCURRENCE index — "the 3rd
time `journal.append` is reached this trial, tear the write at 40% of
the record". Because the expansion is `random.Random(seed)` and the
serve/pool trial harnesses are single-threaded and deterministic, a
failing trial reproduces from its seed alone; the JSON form exists so a
SHRUNK plan (a subset of the generated events) is just as replayable.

Events fire at most once per trial. An event whose site is never
reached (or reached fewer than `occurrence` times) simply never fires —
plans may therefore be generated against the full site catalog without
knowing which code paths a given workload exercises.
"""

from __future__ import annotations

import dataclasses
import json
import random

# action menus per site class (sites.SITES maps site -> class)
ACTIONS = {
    "durable": ("torn", "fsync_fail", "enospc", "delay"),
    "socket": ("short_send", "disconnect", "delay", "duplicate"),
    "crashpoint": ("kill",),
    "clock": ("skew",),
    "replication": ("partition", "delay", "duplicate"),
    "silent_corruption": ("flip",),
    "capacity_loss": ("revoke", "enospc_window"),
}

# recv-side sockets can only lose or delay the reply — tearing or
# duplicating bytes we are RECEIVING is the peer's doing, not ours
_RECV_ACTIONS = ("disconnect", "delay")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    site: str        # registered site name (sites.SITES key)
    occurrence: int  # fire on the Nth arrival at the site (1-based)
    action: str      # one of ACTIONS[class-of-site]
    args: tuple = () # sorted (key, value) pairs — hashable + JSON-stable

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default

    def as_dict(self) -> dict:
        return {
            "site": self.site,
            "occurrence": self.occurrence,
            "action": self.action,
            "args": {k: v for k, v in self.args},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(
            site=str(d["site"]),
            occurrence=int(d["occurrence"]),
            action=str(d["action"]),
            args=tuple(sorted((d.get("args") or {}).items())),
        )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int
    events: tuple = ()

    def as_dict(self) -> dict:
        return {
            "seed": self.seed,
            "events": [e.as_dict() for e in self.events],
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            seed=int(d.get("seed", 0)),
            events=tuple(FaultEvent.from_dict(e)
                         for e in d.get("events", [])),
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())

    def without(self, index: int) -> "FaultPlan":
        """A copy with event `index` removed (the shrinker's move)."""
        ev = self.events[:index] + self.events[index + 1:]
        return FaultPlan(seed=self.seed, events=ev)


def _event_args(rng: random.Random, action: str) -> tuple:
    if action == "torn":
        # the plan-chosen tear point, as a fraction of the record
        return (("frac", round(rng.uniform(0.05, 0.95), 3)),)
    if action == "short_send":
        return (("frac", round(rng.uniform(0.1, 0.9), 3)),)
    if action == "delay":
        return (("s", round(rng.uniform(0.001, 0.02), 4)),)
    if action == "partition":
        # how long the replication link stays blacked out before the
        # partition "heals" and the link may reconnect + resync
        return (("s", round(rng.uniform(0.05, 0.4), 3)),)
    if action == "skew":
        return (("offset_s", round(rng.uniform(0.5, 30.0), 3)),)
    if action == "flip":
        # which array (modulo the dict size), which element (modulo its
        # flat size), and a guaranteed-nonzero perturbation
        return (("key", rng.randint(0, 7)),
                ("pos", rng.randint(0, 1 << 16)),
                ("delta", rng.choice((-3, -1, 1, 2, 5, 17)),))
    if action == "revoke":
        # how many devices drop out of the mesh at once
        return (("n", rng.choice((1, 1, 2))),)
    if action == "enospc_window":
        # how many subsequent preflight probes see a full disk before
        # the window "heals"
        return (("calls", rng.randint(2, 6)),)
    return ()


def generate(
    seed: int,
    classes: tuple = ("durable", "crashpoint"),
    sites: list | None = None,
    max_events: int = 3,
    max_occurrence: int = 4,
) -> FaultPlan:
    """Expand a seed into a plan. `classes` filters the site catalog by
    fault class; `sites` (names) narrows it further — the trial
    harnesses pass the sites their stack actually reaches so generated
    events have a fighting chance of firing."""
    from .sites import SITES

    rng = random.Random(seed)
    pool = [
        (name, cls) for name, cls in sorted(SITES.items())
        if cls in classes and (sites is None or name in sites)
    ]
    if not pool:
        raise ValueError(
            f"no chaos sites match classes={classes!r} sites={sites!r}"
        )
    events = []
    for _ in range(rng.randint(1, max_events)):
        name, cls = rng.choice(pool)
        menu = _RECV_ACTIONS if name.endswith(".recv") else ACTIONS[cls]
        action = rng.choice(menu)
        events.append(FaultEvent(
            site=name,
            occurrence=rng.randint(1, max_occurrence),
            action=action,
            args=_event_args(rng, action),
        ))
    # duplicate (site, occurrence) pairs would shadow each other — keep
    # the first so every event in the plan is reachable in principle
    seen, kept = set(), []
    for e in events:
        if (e.site, e.occurrence) in seen:
            continue
        seen.add((e.site, e.occurrence))
        kept.append(e)
    return FaultPlan(seed=seed, events=tuple(kept))


def shrink(plan: FaultPlan, still_fails) -> FaultPlan:
    """Greedy ddmin: drop events one at a time while `still_fails(plan)`
    keeps reproducing the violation. Terminates because every accepted
    move strictly shrinks the event list; the result is 1-minimal (no
    single event can be removed without losing the failure)."""
    cur = plan
    changed = True
    while changed and len(cur.events) > 1:
        changed = False
        for i in range(len(cur.events)):
            cand = cur.without(i)
            if still_fails(cand):
                cur = cand
                changed = True
                break
    return cur
