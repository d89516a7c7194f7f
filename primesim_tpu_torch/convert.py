"""Carry a machine state between the JAX package and the port.

`state_from_numpy` builds the port's `MachineState` from numpy arrays:
one per field, and the timing knobs and the fault state as mappings under
"knobs" and "faults" (the JAX package's `MachineState` fields after
`np.asarray`, its nested `knobs` and `faults` field by field).
`state_to_numpy` is the inverse. The layouts are the same in both
packages, so a state taken mid-run from one continues bit-exactly in the
other. The fault state's uint32 values (seed, thresholds) become the
port's int64 and come back as int64 of the same value. A fleet's batched
state carries the same way, every array with its leading element axis.

`to_host` brings many tensors of one device to the host with a single
synchronisation: checkpoints and attestation digests read a whole state
through it.
"""

from __future__ import annotations

import numpy as np
import torch

from .config.machine import MachineConfig
from .faults.schedule import FaultState
from .sim.state import MachineState, TimingKnobs, init_state

_NESTED = {"knobs": TimingKnobs, "faults": FaultState}
_FIELDS = tuple(f for f in MachineState._fields if f not in _NESTED)


def state_from_numpy(cfg: MachineConfig, arrays, device, batch: int | None = None) -> MachineState:
    """`arrays` maps every MachineState field to an array, and "knobs" and
    "faults" to mappings of their fields; shapes must match the
    config's, with a leading element axis of `batch` for a batched (fleet)
    state."""
    ref = init_state(cfg, "meta")  # shapes and dtypes only, nothing allocated
    lead = () if batch is None else (batch,)

    def tensor(name, a, like):
        np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        t = torch.from_numpy(np.array(a, dtype=np_dtype, copy=True))
        if t.shape != (*lead, *like.shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} != {(*lead, *like.shape)}"
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


def to_host(tensors) -> list[np.ndarray]:
    """Host numpy arrays of `tensors` (all on one device) with ONE
    synchronisation: on a card each tensor is queued into its own 8-byte
    aligned slice of one pinned buffer, then the stream is waited on once
    (a `.cpu()` per tensor waits once per tensor, from pageable memory).
    On the CPU the arrays are views of the tensors themselves."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type != "cuda":
        return [t.detach().numpy() for t in tensors]
    sizes = [t.numel() * t.element_size() for t in tensors]
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + -(-n // 8) * 8)
    buf = torch.empty(offs[-1], dtype=torch.uint8, pin_memory=True)
    for t, o, n in zip(tensors, offs, sizes):
        buf[o:o + n].view(t.dtype).view(t.shape).copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    host = buf.numpy()
    return [
        host[o:o + n].view(torch.empty((), dtype=t.dtype).numpy().dtype).reshape(t.shape)
        for t, o, n in zip(tensors, offs, sizes)
    ]
