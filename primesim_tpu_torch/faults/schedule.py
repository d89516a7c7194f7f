"""FaultSchedule (user-facing) and FaultState (the state's fault tensors),
the JAX package's `faults/schedule.py`.

A `FaultSchedule` is what the CLI loads from `--fault-schedule file.json`:
a list of scheduled events plus ECC rates and policies. `apply` installs
it in a MachineConfig, and `init_state` carries the config's fault knobs
into the state's `FaultState` through `fault_state_from_config`.

Schedule JSON shape (all fields optional):

    {
      "events": [
        {"step": 100, "kind": "core_failstop", "core": 3},
        {"step": 50,  "kind": "link_fail",    "link": 17},
        {"step": 50,  "kind": "link_degrade", "link": 6, "extra": 8}
      ],
      "flip_l1": 1e-6, "flip_llc": 1e-7, "due_rate": 0.01,
      "dead_policy": "writeback", "due_failstop": false
    }

Malformed schedules raise the typed `FaultConfigError` (site, step,
field) of config.machine, with the JAX package's messages.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import numpy as np
import torch

from ..config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    FAULT_LINK_FAIL,
    FaultConfigError,
    MachineConfig,
)
from .prng import prob_threshold

_KIND_NAMES = {
    "core_failstop": FAULT_CORE_FAILSTOP,
    "link_fail": FAULT_LINK_FAIL,
    "link_degrade": FAULT_LINK_DEGRADE,
}


class FaultState(NamedTuple):
    """The state's fault tensors, the JAX package's FaultState field for
    field. Always present; with cfg.faults_enabled False the step never
    reads it. The schedule arrays are [K = cfg.max_fault_events]; the
    masks evolve as events fire. The four uint32 values of the JAX state
    are int64 here, holding values in [0, 2^32) (faults/prng.py)."""

    seed: torch.Tensor  # [] int64 — the fault PRNG seed
    core_dead: torch.Tensor  # [C] int32 0/1 — failed-stop cores
    link_dead: torch.Tensor  # [n_links] int32 0/1 — failed directed links
    link_extra: torch.Tensor  # [n_links] int32 — degrade cycles per traversal
    ev_step: torch.Tensor  # [K] int32 — firing step (-1 = padding)
    ev_kind: torch.Tensor  # [K] int32 — FAULT_* kind (0 = padding)
    ev_a: torch.Tensor  # [K] int32 — core id / link id
    ev_b: torch.Tensor  # [K] int32 — degrade extra cycles
    flip_l1: torch.Tensor  # [] int64 — L1 per-core per-step flip threshold
    flip_llc: torch.Tensor  # [] int64 — LLC per-bank per-step flip threshold
    due_rate: torch.Tensor  # [] int64 — DUE-classification threshold


def fault_state_from_config(cfg: MachineConfig, device) -> FaultState:
    """The config's fault knobs as a FaultState on `device`."""
    K = cfg.max_fault_events
    nl = cfg.n_tiles * 4
    ev = np.zeros((K, 4), np.int32)
    ev[:, 0] = -1
    for i, e in enumerate(cfg.fault_events):
        ev[i] = [int(x) for x in e]

    def u32(v):
        return torch.tensor(int(v), dtype=torch.int64, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    return FaultState(
        seed=u32(cfg.fault_seed & 0xFFFFFFFF),
        core_dead=zeros(cfg.n_cores),
        link_dead=zeros(nl),
        link_extra=zeros(nl),
        **{k: torch.from_numpy(np.ascontiguousarray(ev[:, i])).to(device)
           for i, k in enumerate(("ev_step", "ev_kind", "ev_a", "ev_b"))},
        flip_l1=u32(prob_threshold(cfg.fault_flip_l1)),
        flip_llc=u32(prob_threshold(cfg.fault_flip_llc)),
        due_rate=u32(prob_threshold(cfg.fault_due_rate)),
    )


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """User-facing fault schedule (CLI/config layer)."""

    events: tuple = ()  # ((step, kind, a, b), ...) — FAULT_* kinds
    flip_l1: float = 0.0
    flip_llc: float = 0.0
    due_rate: float = 0.0
    dead_policy: str = "writeback"
    due_failstop: bool = False

    def apply(self, cfg: MachineConfig, seed: int = 0) -> MachineConfig:
        """`cfg` with this schedule installed and faults enabled.

        `max_fault_events` is rounded up to the next power of two (min 1),
        as the JAX package rounds it for its compile key."""
        k = max(1, len(self.events))
        k = 1 << (k - 1).bit_length()
        return dataclasses.replace(
            cfg,
            faults_enabled=True,
            max_fault_events=max(cfg.max_fault_events, k),
            fault_dead_policy=self.dead_policy,
            fault_due_failstop=self.due_failstop,
            fault_seed=int(seed),
            fault_events=tuple(tuple(int(x) for x in e) for e in self.events),
            fault_flip_l1=float(self.flip_l1),
            fault_flip_llc=float(self.flip_llc),
            fault_due_rate=float(self.due_rate),
        )


def _event_from_dict(d: dict) -> tuple:
    if not isinstance(d, dict):
        raise FaultConfigError(
            f"event {d!r} must be an object", field="events"
        )
    kind_s = d.get("kind")
    if kind_s not in _KIND_NAMES:
        raise FaultConfigError(
            f"unknown kind {kind_s!r} (valid: {sorted(_KIND_NAMES)})",
            step=d.get("step"), field="kind",
        )
    kind = _KIND_NAMES[kind_s]
    if "step" not in d:
        raise FaultConfigError("event missing 'step'", field="step")
    estep = int(d["step"])
    if kind == FAULT_CORE_FAILSTOP:
        if "core" not in d:
            raise FaultConfigError(
                "core_failstop event missing 'core'", step=estep,
                field="core",
            )
        return (estep, kind, int(d["core"]), 0)
    if "link" not in d:
        raise FaultConfigError(
            f"{kind_s} event missing 'link'", step=estep, field="link"
        )
    extra = int(d.get("extra", 0)) if kind == FAULT_LINK_DEGRADE else 0
    return (estep, kind, int(d["link"]), extra)


def schedule_from_dict(d: dict) -> FaultSchedule:
    known = {
        "events", "flip_l1", "flip_llc", "due_rate", "dead_policy",
        "due_failstop",
    }
    unknown = sorted(set(d) - known)
    if unknown:
        raise FaultConfigError(
            f"unknown schedule field(s) {unknown}", field=unknown[0]
        )
    return FaultSchedule(
        events=tuple(_event_from_dict(e) for e in d.get("events", ())),
        flip_l1=float(d.get("flip_l1", 0.0)),
        flip_llc=float(d.get("flip_llc", 0.0)),
        due_rate=float(d.get("due_rate", 0.0)),
        dead_policy=str(d.get("dead_policy", "writeback")),
        due_failstop=bool(d.get("due_failstop", False)),
    )


def load_schedule(path: str) -> FaultSchedule:
    """Load a fault-schedule JSON file (typed errors on malformed input)."""
    try:
        with open(path) as f:
            d = json.load(f)
    except json.JSONDecodeError as e:
        raise FaultConfigError(f"{path}: not valid JSON ({e})") from e
    if not isinstance(d, dict):
        raise FaultConfigError(f"{path}: schedule must be a JSON object")
    return schedule_from_dict(d)
