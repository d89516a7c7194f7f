"""Carry a machine state between the JAX package and the port.

`state_from_numpy` builds the port's `MachineState` from numpy arrays:
one per field, and the timing knobs as a mapping under "knobs" (the JAX
package's `MachineState` fields after `np.asarray`, its `faults` entry,
which this slice does not model, left out). `state_to_numpy` is the
inverse. The layouts are the same in both packages, so a state taken
mid-run from one continues bit-exactly in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .config.machine import MachineConfig
from .sim.state import MachineState, TimingKnobs, init_state

_FIELDS = tuple(f for f in MachineState._fields if f != "knobs")


def state_from_numpy(cfg: MachineConfig, arrays, device) -> MachineState:
    """`arrays` maps every MachineState field to an array and "knobs" to
    a mapping of TimingKnobs fields; shapes must match the config's."""
    ref = init_state(cfg, "meta")  # shapes only, nothing allocated

    def tensor(name, a, like):
        t = torch.from_numpy(np.array(a, dtype=np.int32, copy=True))
        if t.shape != like.shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} != {tuple(like.shape)}"
            )
        return t.to(device)

    knobs = TimingKnobs(
        **{k: tensor(f"knobs.{k}", arrays["knobs"][k], getattr(ref.knobs, k))
           for k in TimingKnobs._fields}
    )
    return MachineState(
        **{f: tensor(f, arrays[f], getattr(ref, f)) for f in _FIELDS},
        knobs=knobs,
    )


def state_to_numpy(st: MachineState) -> dict:
    """Every field as a host int32 numpy array; "knobs" as a dict."""
    out = {f: getattr(st, f).cpu().numpy() for f in _FIELDS}
    out["knobs"] = {k: v.cpu().numpy() for k, v in st.knobs._asdict().items()}
    return out
