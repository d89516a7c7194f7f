"""Carry a machine state between the JAX package and the port.

`state_from_numpy` builds the port's `MachineState` from numpy arrays:
one per field, and the timing knobs and the fault state as mappings under
"knobs" and "faults" (the JAX package's `MachineState` fields after
`np.asarray`, its nested `knobs` and `faults` field by field).
`state_to_numpy` is the inverse. The layouts are the same in both
packages, so a state taken mid-run from one continues bit-exactly in the
other. The fault state's uint32 values (seed, thresholds) become the
port's int64 and come back as int64 of the same value.
"""

from __future__ import annotations

import numpy as np
import torch

from .config.machine import MachineConfig
from .faults.schedule import FaultState
from .sim.state import MachineState, TimingKnobs, init_state

_NESTED = {"knobs": TimingKnobs, "faults": FaultState}
_FIELDS = tuple(f for f in MachineState._fields if f not in _NESTED)


def state_from_numpy(cfg: MachineConfig, arrays, device) -> MachineState:
    """`arrays` maps every MachineState field to an array, and "knobs" and
    "faults" to mappings of their fields; shapes must match the
    config's."""
    ref = init_state(cfg, "meta")  # shapes and dtypes only, nothing allocated

    def tensor(name, a, like):
        np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        t = torch.from_numpy(np.array(a, dtype=np_dtype, copy=True))
        if t.shape != like.shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} != {tuple(like.shape)}"
            )
        return t.to(device)

    nested = {
        n: cls(**{k: tensor(f"{n}.{k}", arrays[n][k], getattr(getattr(ref, n), k))
                  for k in cls._fields})
        for n, cls in _NESTED.items()
    }
    return MachineState(
        **{f: tensor(f, arrays[f], getattr(ref, f)) for f in _FIELDS}, **nested
    )


def state_to_numpy(st: MachineState) -> dict:
    """Every field as a host numpy array; "knobs" and "faults" as dicts."""
    out = {f: getattr(st, f).cpu().numpy() for f in _FIELDS}
    for n in _NESTED:
        out[n] = {k: v.cpu().numpy() for k, v in getattr(st, n)._asdict().items()}
    return out
