"""Checkpoint / resume of one engine (SURVEY.md §5.4): the solo part of
the JAX package's `sim/checkpoint.py`, in its file format.

A checkpoint is one `.npz`: every state field (nested knobs and fault
state flattened to `state_<field>__<sub>` keys), the 64-bit counter and
clock bases, and fingerprints of the config and the trace, so resuming
against another machine or workload is an error, not silent corruption.
The keys and dtypes are the JAX package's format 7, so a snapshot either
engine writes resumes bit-exactly in the other: the port's int64 fault
values (seed and thresholds, in [0, 2^32)) are written as the JAX
state's uint32 and read back to int64, and the port writes no prefix-fork
provenance (`prefix_steps` 0, an empty `prefix_cache_key`) and no
attestation members.

Durability (DESIGN.md §10): every save goes through `atomic_save_npz`: a
writer-unique temp file, fsync, `os.replace`, a directory fsync; a
per-array CRC32 manifest turns silent media corruption into a typed
`CheckpointCorrupt` at load time. The JAX package's disk-pressure
preflight and chaos site around that write are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zlib

import numpy as np

from ..config.machine import MachineConfig
from ..convert import state_from_numpy, state_to_numpy
from ..stats.counters import COUNTER_NAMES

_FORMAT = 7  # the JAX package's format: see its sim/checkpoint.py

_NESTED = ("knobs", "faults")
# the fault state's uint32 values (int64 in the port)
_U32 = {"faults": ("seed", "flip_l1", "flip_llc", "due_rate")}

_CRC_KEY = "crc_json"  # reserved npz member: {array name: crc32} manifest


class CheckpointCorrupt(ValueError):
    """The checkpoint file is torn, truncated, or fails CRC verification.

    Distinct from the plain ValueErrors the loader raises for MISMATCHED
    checkpoints (wrong config, trace or kind): a mismatch means a healthy
    snapshot met the wrong engine, corruption means THIS file is unusable
    and an older snapshot is the right fallback."""


def atomic_save_npz(path: str, **arrays) -> None:
    """Write an npz atomically with per-array CRC32s.

    The bytes go to a writer-unique temp file beside `path` first, are
    flushed and fsynced, and only then `os.replace`d over `path`, so
    `path` always holds either the previous complete snapshot or the new
    one, never a torn hybrid. A `crc_json` member maps every array name
    to the CRC32 of its contiguous bytes; `load_verified_npz` recomputes
    and compares before any array is trusted."""
    named = {k: np.asarray(v) for k, v in arrays.items()}
    if _CRC_KEY in named:
        raise ValueError(f"array name {_CRC_KEY!r} is reserved")
    crcs = {
        k: zlib.crc32(np.ascontiguousarray(v).tobytes())
        for k, v in named.items()
    }
    named[_CRC_KEY] = np.frombuffer(
        json.dumps(crcs, sort_keys=True).encode(), dtype=np.uint8
    )
    # unique per writer, not per destination: two writers of one path
    # must not rename each other's temp files away
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp",
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **named)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the directory so the rename itself survives power loss
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def load_verified_npz(path: str) -> dict[str, np.ndarray]:
    """Load an npz fully into host memory, verifying the CRC manifest.

    A missing file stays FileNotFoundError ("no snapshot yet" and "bad
    snapshot" remain distinguishable); any other read or decode failure
    and any CRC mismatch raises CheckpointCorrupt. Files without a
    manifest load unverified (zipfile's own member CRCs still catch torn
    writes)."""
    try:
        with np.load(path) as z:
            data = {k: np.asarray(z[k]) for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path}: unreadable checkpoint ({type(e).__name__}: {e})"
        ) from e
    if _CRC_KEY in data:
        try:
            crcs = json.loads(bytes(data.pop(_CRC_KEY)).decode())
        except Exception as e:
            raise CheckpointCorrupt(
                f"{path}: unreadable CRC manifest ({e})"
            ) from e
        for k, want in crcs.items():
            if k not in data:
                raise CheckpointCorrupt(
                    f"{path}: array {k!r} in CRC manifest is missing"
                )
            got = zlib.crc32(np.ascontiguousarray(data[k]).tobytes())
            if got != int(want):
                raise CheckpointCorrupt(
                    f"{path}: array {k!r} fails CRC32 "
                    f"(stored {int(want)}, recomputed {got})"
                )
    return data


def _require_format(z, path: str) -> None:
    """Refuse any snapshot not written in format 7."""
    got = int(z["format"]) if "format" in z else None
    if got != _FORMAT:
        raise ValueError(
            f"{path}: unsupported checkpoint format {got} (this build "
            f"reads format {_FORMAT} only — re-run to regenerate the "
            "snapshot)"
        )


def _str_field(z, key: str) -> str:
    """Decode an optional uint8-string npz member ('' when absent)."""
    return bytes(z[key]).decode() if key in z else ""


def _state_arrays(st) -> dict[str, np.ndarray]:
    """The state as npz arrays: plain fields as `state_<name>`, the nested
    knobs and fault state as `state_<name>__<sub>`, the fault state's
    uint32 values as uint32."""
    arrays = {}
    for k, v in state_to_numpy(st).items():
        if k in _NESTED:
            for kk, vv in v.items():
                if kk in _U32.get(k, ()):
                    vv = vv.astype(np.uint32)
                arrays[f"state_{k}__{kk}"] = vv
        else:
            arrays[f"state_{k}"] = v
    return arrays


def _state_from(z, cfg: MachineConfig, device):
    """The port's MachineState on `device` from a format-7 npz (inverse of
    _state_arrays; uint32 values come back as int64)."""
    from .state import MachineState

    arrays = {}
    for k in MachineState._fields:
        if k in _NESTED:
            pre = f"state_{k}__"
            arrays[k] = {
                n[len(pre):]: (a.astype(np.int64) if a.dtype == np.uint32 else a)
                for n, a in z.items() if n.startswith(pre)
            }
        else:
            arrays[k] = z[f"state_{k}"]
    return state_from_numpy(cfg, arrays, device)


def trace_fingerprint(trace) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(trace.events).tobytes())
    h.update(np.ascontiguousarray(trace.lengths).tobytes())
    # addressing interpretation is part of the workload identity: the same
    # raw arrays read as byte- vs line-addressed are different workloads
    h.update(
        f"line_addressed={trace.line_addressed},{trace.line_bits}".encode()
    )
    return h.hexdigest()


def save_checkpoint(path: str, engine) -> None:
    """Snapshot an Engine mid-run (drains the device counters first)."""
    engine._drain()
    arrays = _state_arrays(engine.state)
    arrays["host_counters"] = np.stack(
        [engine.host_counters[k] for k in COUNTER_NAMES]
    )
    atomic_save_npz(
        path,
        format=np.int64(_FORMAT),
        cycle_base=np.int64(engine.cycle_base),
        steps_run=np.int64(engine.steps_run),
        prefix_steps=np.int64(0),
        prefix_cache_key=np.frombuffer(b"", dtype=np.uint8),
        config_json=np.frombuffer(
            engine.cfg.to_json().encode(), dtype=np.uint8
        ),
        trace_sha=np.frombuffer(
            trace_fingerprint(engine.trace).encode(), dtype=np.uint8
        ),
        **arrays,
    )


def load_checkpoint(path: str, engine) -> None:
    """Restore a snapshot into a freshly constructed Engine, built with the
    config and trace the checkpoint was taken under (checked by
    fingerprint). Stream, fleet and per-job element snapshots are refused
    with the JAX package's messages."""
    z = load_verified_npz(path)
    _require_format(z, path)
    if "stream" in z:
        raise ValueError(
            f"{path}: streaming checkpoint — resume it with a StreamEngine"
        )
    if "fleet" in z:
        raise ValueError(
            f"{path}: fleet checkpoint — resume it with a FleetEngine"
        )
    if "element" in z:
        raise ValueError(
            f"{path}: per-job element checkpoint — splice it into a "
            "serving fleet (FleetEngine.restore_element)"
        )
    cfg_json = bytes(z["config_json"]).decode()
    if MachineConfig.from_json(cfg_json) != engine.cfg:
        raise ValueError(f"{path}: checkpoint config does not match engine config")
    sha = bytes(z["trace_sha"]).decode()
    if sha != trace_fingerprint(engine.trace):
        raise ValueError(f"{path}: checkpoint trace does not match engine trace")
    if z["state_counters"].shape[0] != len(COUNTER_NAMES):
        raise ValueError(
            f"{path}: checkpoint has {z['state_counters'].shape[0]} counter "
            f"rows but this build defines {len(COUNTER_NAMES)} — saved by an "
            "incompatible version"
        )
    engine.state = _state_from(z, engine.cfg, engine.device)
    engine._stepped = None  # scrub_offsets re-reads the loaded step
    engine.cycle_base = int(z["cycle_base"])
    engine.steps_run = int(z["steps_run"])
    hc = z["host_counters"]
    engine.host_counters = {
        k: hc[i].astype(np.int64) for i, k in enumerate(COUNTER_NAMES)
    }
