"""Checkpoint / resume of one engine, one fleet, one stream or one fleet
element (SURVEY.md §5.4), and the warm-state cache of prefix forking
(DESIGN.md §16): the JAX package's `sim/checkpoint.py` for the port, in
its file format.

A checkpoint is one `.npz`: every state field (nested knobs and fault
state flattened to `state_<field>__<sub>` keys), the 64-bit counter and
clock bases, and fingerprints of the config and the trace, so resuming
against another machine or workload is an error, not silent corruption.
The keys and dtypes are the JAX package's format 7, so a snapshot either
engine writes resumes bit-exactly in the other: the port's int64 fault
values (seed and thresholds, in [0, 2^32)) are written as the JAX
state's uint32 and read back to int64. Prefix-fork provenance (the steps
of shared prefix an engine or each fleet element was forked from, and
the warm-cache key of that prefix) is written and read as the JAX
package does. A fleet snapshot holds the batched state (leading element
axis), per-element cycle bases, step counts and config and trace
fingerprints, and the [n_counters, B, C] host counters, under the
`fleet` key. A stream snapshot (a `StreamEngine` at a window boundary)
adds the per-core stream cursors and the window size, under the `stream`
key. An element snapshot (one serving-fleet slot, solo-shaped, under the
`element` key) is the serving daemon's per-job checkpoint: it splices
into any slot of any serving fleet of the same geometry.

A sharded state (`parallel/sharding.py`) is written whole, in the same
format, so a snapshot taken on N shards loads on M shards, unsharded, or
in the JAX package; the solo and fleet loaders lay the state out again
over the engine's mesh.

Attestation (DESIGN.md §24): when the engine carries a fingerprint chain
(`engine.attest`), solo and stream snapshots add the chain's members
(`attest_head`, `attest_chunks`, `attest_start`, `attest_chunk_steps`),
fleet snapshots an `attest_json` list, and element snapshots also an
`attest_payload_sha` self-digest of their arrays taken before the bytes
go to disk; the loaders seed the engine's chain from them, so a resumed
run continues the same chain, across the packages too. With no chain the
writers add nothing: an attest-off snapshot holds exactly the members it
held before attestation existed.

Durability (DESIGN.md §10): every save goes through `atomic_save_npz`: a
disk-pressure preflight (`util/diskpressure.py`) before any byte lands, a
writer-unique temp file, fsync, the chaos site `checkpoint.write`,
`os.replace`, a directory fsync; a per-array CRC32 manifest turns silent
media corruption into a typed `CheckpointCorrupt` at load time.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zlib

import numpy as np

from ..chaos import sites as chaos
from ..config.machine import MachineConfig
from ..convert import state_from_numpy, to_host
from ..stats.counters import COUNTER_NAMES
from ..util import diskpressure

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
    # disk-pressure gate before any byte lands: the uncompressed total
    # bounds the compressed npz. Under pressure this runs the
    # evict -> compact ladder and raises DiskPressureError rather than
    # letting savez die mid-write with an ENOSPC-torn temp file
    diskpressure.preflight(
        path, sum(v.nbytes for v in named.values()), kind="checkpoint"
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
        # chaos durable-write site: a torn/fsync fault here dies BEFORE
        # the rename, so `path` keeps the previous complete snapshot
        chaos.durable("checkpoint.write", path=tmp)
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
    uint32 values as uint32, all brought to the host in one transfer
    (`convert.to_host`). The order is the JAX package's leaf order
    (`jax.tree_util.tree_leaves` of its MachineState: field order, the
    nested tuples in their own field order), so the values are also the
    leaves an attestation digest hashes (attest/chain.py)."""
    return _state_arrays_many([st])[0]


def _state_arrays_many(states) -> list[dict[str, np.ndarray]]:
    """`_state_arrays` of several states (a fleet's element views) with
    one transfer for all of them."""
    from .state import MachineState

    names, tensors = [], []
    for st in states:
        for f in MachineState._fields:
            v = getattr(st, f)
            if f in _NESTED:
                for kk in type(v)._fields:
                    names.append((f"state_{f}__{kk}", kk in _U32.get(f, ())))
                    tensors.append(getattr(v, kk))
            else:
                names.append((f"state_{f}", False))
                tensors.append(v)
    out, per = [], len(names) // max(1, len(states))
    host = to_host(tensors)
    for j in range(len(states)):
        out.append({
            name: a.astype(np.uint32) if u32 else a
            for (name, u32), a in zip(names[j * per:(j + 1) * per],
                                      host[j * per:(j + 1) * per])
        })
    return out


def _state_from(z, cfg: MachineConfig, device, batch: int | None = None):
    """The port's MachineState on `device` from a format-7 npz (inverse of
    _state_arrays; uint32 values come back as int64), batched when
    `batch` gives the element count."""
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
    return state_from_numpy(cfg, arrays, device, batch)


def trace_fingerprint(trace) -> str:
    """The JAX package's trace fingerprint: sha256 of the events' bytes,
    the lengths' and the addressing. The events are hashed a block of
    cores at a time (the same bytes in the same order), so a
    memory-mapped trace is never copied whole."""
    h = hashlib.sha256()
    ev = trace.events
    rows = max(1, (1 << 26) // max(1, ev[0].size if len(ev) else 1))
    for lo in range(0, len(ev), rows):
        h.update(np.ascontiguousarray(ev[lo:lo + rows]).tobytes())
    h.update(np.ascontiguousarray(trace.lengths).tobytes())
    # addressing interpretation is part of the workload identity: the same
    # raw arrays read as byte- vs line-addressed are different workloads
    h.update(
        f"line_addressed={trace.line_addressed},{trace.line_bits}".encode()
    )
    return h.hexdigest()


def _payload_digest(arrays: dict, cycle_base, steps_run) -> str:
    """Self-digest over an element checkpoint's payload arrays, computed
    from the in-memory values BEFORE the bytes head to disk. The CRC
    manifest proves the file holds what was written; this proves what
    was written is what the engine held: the two together bracket the
    silent-corruption site `checkpoint.payload` (DESIGN.md §24)."""
    h = hashlib.sha256(b"ptckpt-attest1")
    h.update(np.int64(steps_run).tobytes())
    h.update(np.int64(cycle_base).tobytes())
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]))
    return h.hexdigest()


def _attest_members(payload: dict | None) -> dict:
    """Optional attestation-chain members, written only when the engine
    carries a chain."""
    if payload is None:
        return {}
    return {
        "attest_head": np.frombuffer(str(payload["head"]).encode(), dtype=np.uint8),
        "attest_chunks": np.int64(payload["chunks"]),
        "attest_start": np.int64(payload["start"]),
        "attest_chunk_steps": np.int64(payload["chunk_steps"]),
    }


def _attest_from(z) -> dict | None:
    if "attest_chunks" not in z:
        return None
    return {
        "head": _str_field(z, "attest_head"),
        "chunks": int(z["attest_chunks"]),
        "start": int(z["attest_start"]),
        "chunk_steps": int(z["attest_chunk_steps"]),
    }


def _chain_payload(eng) -> dict | None:
    at = getattr(eng, "attest", None)
    return None if at is None else at.payload()


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
        prefix_steps=np.int64(getattr(engine, "prefix_steps", 0) or 0),
        prefix_cache_key=np.frombuffer(
            str(getattr(engine, "prefix_cache_key", "") or "").encode(),
            dtype=np.uint8,
        ),
        config_json=np.frombuffer(
            engine.cfg.to_json().encode(), dtype=np.uint8
        ),
        trace_sha=np.frombuffer(
            trace_fingerprint(engine.trace).encode(), dtype=np.uint8
        ),
        **_attest_members(_chain_payload(engine)),
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
    if getattr(engine, "mesh", None) is not None:  # re-laid over the engine's mesh
        from ..parallel.sharding import shard_state

        engine.state = shard_state(engine.mesh, engine.state)
    engine._stepped = None  # scrub_offsets re-reads the loaded step
    engine.cycle_base = int(z["cycle_base"])
    engine.steps_run = int(z["steps_run"])
    engine.prefix_steps = int(z["prefix_steps"]) if "prefix_steps" in z else 0
    engine.prefix_cache_key = _str_field(z, "prefix_cache_key") or None
    hc = z["host_counters"]
    engine.host_counters = {
        k: hc[i].astype(np.int64) for i, k in enumerate(COUNTER_NAMES)
    }
    if getattr(engine, "attest", None) is not None:
        engine.attest.seed(_attest_from(z), int(z["steps_run"]))


def save_stream_checkpoint(path: str, eng) -> None:
    """Snapshot a StreamEngine at a window boundary (its consistent cut,
    between two `_advance_window` calls): the state (its `ptr` the
    window-relative count the last window consumed), the per-core stream
    cursors, the window size and the 64-bit host accumulators, under the
    `stream` key, as the JAX package writes it."""
    arrays = _state_arrays(eng.state)
    arrays["host_counters"] = np.stack(
        [eng.host_counters[k] for k in COUNTER_NAMES]
    )
    atomic_save_npz(
        path,
        format=np.int64(_FORMAT),
        stream=np.int64(1),
        cycle_base=np.int64(eng.cycle_base),
        steps_run=np.int64(eng.steps_run),
        cursor=np.asarray(eng.cursor, np.int64),
        window_events=np.int64(eng.W),
        config_json=np.frombuffer(eng.cfg.to_json().encode(), dtype=np.uint8),
        trace_sha=np.frombuffer(
            trace_fingerprint(eng.trace).encode(), dtype=np.uint8
        ),
        **_attest_members(_chain_payload(eng)),
        **arrays,
    )


def load_stream_checkpoint(path: str, eng) -> None:
    """Restore a stream snapshot (the port's or the JAX package's) into
    a freshly built StreamEngine on the same config, trace and window
    size (fingerprint-checked, with the JAX package's messages). The next
    window fills from the restored cursors: bit-exact with an
    uninterrupted run. Solo, fleet and element snapshots are refused."""
    z = load_verified_npz(path)
    _require_format(z, path)
    if "stream" not in z:
        raise ValueError(f"{path}: not a compatible streaming checkpoint")
    if MachineConfig.from_json(bytes(z["config_json"]).decode()) != eng.cfg:
        raise ValueError(f"{path}: checkpoint config does not match engine")
    if bytes(z["trace_sha"]).decode() != trace_fingerprint(eng.trace):
        raise ValueError(f"{path}: checkpoint trace does not match engine")
    if int(z["window_events"]) != eng.W:
        raise ValueError(
            f"{path}: checkpoint window_events {int(z['window_events'])} "
            f"!= engine {eng.W} (windows must match for bit-exact resume)"
        )
    eng.state = _state_from(z, eng.cfg, eng.device)
    eng.cursor = z["cursor"].astype(np.int64)
    eng.cycle_base = int(z["cycle_base"])
    eng.steps_run = int(z["steps_run"])
    hc = z["host_counters"]
    eng.host_counters = {
        k: hc[i].astype(np.int64) for i, k in enumerate(COUNTER_NAMES)
    }
    if getattr(eng, "attest", None) is not None:
        eng.attest.seed(_attest_from(z), int(z["steps_run"]))


def save_element_checkpoint(path: str, fleet, i: int, job_id: str = "",
                            trace=None) -> None:
    """Snapshot ONE fleet element solo-shaped: the serving daemon's
    per-job checkpoint (DESIGN.md §14). A fleet chunk boundary is a
    consistent per-element cut (elements are independent), so the saved
    state splices into ANY slot of ANY serving fleet on the same geometry
    (`FleetEngine.restore_element`) and resumes bit-exactly.

    `trace` overrides the fingerprinted workload: a job admitted into a
    small bucket runs a leading WINDOW of its trace there while its
    identity stays the FULL trace, which its checkpoints must verify
    against. With an attestation chain on the slot the snapshot carries
    the chain and a self-digest of its arrays, taken before the chaos
    site `checkpoint.payload` and the write."""
    fleet._drain()
    arrays = _state_arrays(fleet.element_state(i))
    arrays["host_counters"] = np.stack(
        [fleet.host_counters[k][i] for k in COUNTER_NAMES]
    )  # [n_counters, C]
    at = fleet.attest.payload(i) if getattr(fleet, "attest", None) is not None else None
    extra = _attest_members(at)
    if at is not None:
        extra["attest_payload_sha"] = np.frombuffer(
            _payload_digest(arrays, fleet.cycle_base[i], fleet.steps_run[i]).encode(),
            dtype=np.uint8,
        )
    chaos.corrupt("checkpoint.payload", {"host_counters": arrays["host_counters"]})
    pre = getattr(fleet, "prefix_steps", None)
    keys = getattr(fleet, "prefix_cache_keys", None)
    atomic_save_npz(
        path,
        format=np.int64(_FORMAT),
        element=np.int64(1),
        cycle_base=np.int64(fleet.cycle_base[i]),
        steps_run=np.int64(fleet.steps_run[i]),
        prefix_steps=np.int64(int(pre[i]) if pre is not None else 0),
        prefix_cache_key=np.frombuffer(
            str((keys[i] if keys is not None else "") or "").encode(), dtype=np.uint8
        ),
        job_id=np.frombuffer(str(job_id).encode(), dtype=np.uint8),
        config_json=np.frombuffer(fleet.elem_cfgs[i].to_json().encode(), dtype=np.uint8),
        trace_sha=np.frombuffer(
            trace_fingerprint(trace if trace is not None else fleet.traces[i]).encode(),
            dtype=np.uint8,
        ),
        **extra,
        **arrays,
    )


def load_element_checkpoint(path: str, cfg, trace, device="cpu") -> dict:
    """Load a per-job element checkpoint (the port's or the JAX
    package's), checked against the job's effective config and trace
    (fingerprints, as the solo loader checks them) and, when it carries
    one, against its attestation self-digest (`AttestationError` when the
    payload is not what the engine committed). Returns the dict
    `FleetEngine.restore_element` takes: the solo-shaped state on
    `device`, the 64-bit cycle base and step count, the host counters,
    the job id, prefix provenance and the chain payload (None without)."""
    z = load_verified_npz(path)
    _require_format(z, path)
    if "element" not in z:
        raise ValueError(f"{path}: not a compatible element checkpoint")
    if MachineConfig.from_json(bytes(z["config_json"]).decode()) != cfg:
        raise ValueError(f"{path}: checkpoint config does not match job")
    if bytes(z["trace_sha"]).decode() != trace_fingerprint(trace):
        raise ValueError(f"{path}: checkpoint trace does not match job")
    if z["state_counters"].shape[0] != len(COUNTER_NAMES):
        raise ValueError(
            f"{path}: checkpoint has {z['state_counters'].shape[0]} counter "
            f"rows but this build defines {len(COUNTER_NAMES)} — saved by an "
            "incompatible version"
        )
    if "attest_payload_sha" in z:
        from ..attest.errors import AttestationError

        arrays = {k: v for k, v in z.items() if k.startswith("state_")}
        arrays["host_counters"] = z["host_counters"]
        got = _payload_digest(arrays, z["cycle_base"], z["steps_run"])
        if got != _str_field(z, "attest_payload_sha"):
            raise AttestationError(
                f"{path}: checkpoint payload does not match its attest "
                "self-digest — the file verifies its CRC manifest but "
                "holds values the engine never committed (silent "
                "corruption between hash and write)",
                site="checkpoint.payload",
                unit=_str_field(z, "job_id"),
            )
    hc = z["host_counters"]
    return {
        "state": _state_from(z, cfg, device),
        "cycle_base": np.int64(z["cycle_base"]),
        "steps_run": np.int64(z["steps_run"]),
        "job_id": bytes(z["job_id"]).decode(),
        "prefix_steps": int(z["prefix_steps"]) if "prefix_steps" in z else 0,
        "prefix_cache_key": _str_field(z, "prefix_cache_key") or None,
        "host_counters": {
            k: hc[i].astype(np.int64) for i, k in enumerate(COUNTER_NAMES)
        },
        "attest": _attest_from(z),
    }


def save_fleet_checkpoint(path: str, fleet) -> None:
    """Snapshot a FleetEngine mid-run: the BATCHED state (leading axis =
    fleet element), per-element 64-bit cycle bases and counter
    accumulators, and per-element config/trace fingerprints. Any chunk
    boundary is a consistent cut, exactly as for the solo engine."""
    fleet._drain()
    arrays = _state_arrays(fleet.state)
    arrays["host_counters"] = np.stack(
        [fleet.host_counters[k] for k in COUNTER_NAMES]
    )  # [n_counters, B, C]
    B = len(fleet.elem_cfgs)
    pre = getattr(fleet, "prefix_steps", None)
    if pre is None:
        pre = np.zeros(B, np.int64)
    keys = getattr(fleet, "prefix_cache_keys", None) or [None] * B
    atomic_save_npz(
        path,
        format=np.int64(_FORMAT),
        fleet=np.int64(1),
        cycle_base=np.asarray(fleet.cycle_base, np.int64),  # [B]
        steps_run=np.asarray(fleet.steps_run, np.int64),  # [B]
        prefix_steps=np.asarray(pre, np.int64),  # [B]
        prefix_keys_json=np.frombuffer(
            json.dumps([k or None for k in keys]).encode(), dtype=np.uint8
        ),
        configs_json=np.frombuffer(
            json.dumps([json.loads(c.to_json()) for c in fleet.elem_cfgs]).encode(),
            dtype=np.uint8,
        ),
        trace_shas=np.frombuffer(
            ",".join(trace_fingerprint(t) for t in fleet.traces).encode(),
            dtype=np.uint8,
        ),
        **(
            {"attest_json": np.frombuffer(
                json.dumps([fleet.attest.payload(i) for i in range(B)],
                           sort_keys=True).encode(), dtype=np.uint8)}
            if getattr(fleet, "attest", None) is not None else {}
        ),
        **arrays,
    )


def load_fleet_checkpoint(path: str, fleet) -> None:
    """Restore a fleet snapshot (the port's or the JAX package's) into a
    freshly built FleetEngine over the same per-element (config, trace)
    list, order included (the batch axis is positional). Resuming is
    bit-exact per element."""
    z = load_verified_npz(path)
    _require_format(z, path)
    if "fleet" not in z:
        raise ValueError(f"{path}: not a compatible fleet checkpoint")
    cfgs = [
        MachineConfig.from_dict(d)
        for d in json.loads(bytes(z["configs_json"]).decode())
    ]
    if cfgs != list(fleet.elem_cfgs):
        raise ValueError(f"{path}: checkpoint element configs do not match fleet")
    shas = bytes(z["trace_shas"]).decode().split(",")
    if shas != [trace_fingerprint(t) for t in fleet.traces]:
        raise ValueError(f"{path}: checkpoint element traces do not match fleet")
    if z["state_counters"].shape[1] != len(COUNTER_NAMES):
        raise ValueError(
            f"{path}: checkpoint has {z['state_counters'].shape[1]} counter "
            f"rows but this build defines {len(COUNTER_NAMES)} — saved by an "
            "incompatible version"
        )
    fleet.state = _state_from(z, fleet.cfg, fleet.device, batch=len(cfgs))
    if getattr(fleet, "mesh", None) is not None:
        from ..parallel.sharding import shard_fleet_state

        fleet.state = shard_fleet_state(fleet.mesh, fleet.state)
    fleet._stepped = None  # live flags and step numbers re-read from it
    fleet.cycle_base = z["cycle_base"].astype(np.int64)
    fleet.steps_run = z["steps_run"].astype(np.int64)
    if "prefix_steps" in z:
        fleet.prefix_steps = z["prefix_steps"].astype(np.int64)
    if "prefix_keys_json" in z:
        fleet.prefix_cache_keys = json.loads(bytes(z["prefix_keys_json"]).decode())
    hc = z["host_counters"]
    fleet.host_counters = {
        k: hc[i].astype(np.int64) for i, k in enumerate(COUNTER_NAMES)
    }
    if getattr(fleet, "attest", None) is not None and "attest_json" in z:
        from ..attest import AttestChain

        for i, p in enumerate(json.loads(bytes(z["attest_json"]).decode())):
            if p and fleet.attest.chain(i) is not None:
                fleet.attest.chains[i] = AttestChain.from_payload(p)


# ---------------------------------------------------------------------------
# Warm-state cache (prefix forking, DESIGN.md §16)
#
# Content-addressed snapshots of a solo engine after P steps of a
# workload, in the JAX package's files and under its keys, so an entry
# either package writes serves the other. An entry is valid for any run
# whose first P steps are provably identical to the producer's, which the
# key enforces by hashing exactly the inputs that can influence them:
#
#   - the checkpoint format (state layout identity)
#   - the trace fingerprint (events + lengths + addressing)
#   - the normalized-geometry hash (cfg.timing_normalized().to_json())
#   - the timing-knob values (knobs_from_config leaves)
#   - the fault-schedule PREFIX: scheduled events with step < P (an event
#     at step S fires while executing step index S)
#   - the ECC block (seed + flip/DUE thresholds) ONLY when a rate is
#     nonzero: with all of them 0 the seed is architecturally unreachable
#     and seed-varying sweep elements share one entry
#   - P itself
#
# chunk_steps is not part of the key: every absolute observable after P
# steps is chunking-invariant.
# ---------------------------------------------------------------------------

_WARM_DEFAULT_MAX_BYTES = 2 << 30  # 2 GiB before LRU eviction kicks in


def warm_cache_root() -> str:
    """The warm-cache directory: $PRIMETPU_CACHE_DIR, or a per-user
    default under ~/.cache. Created on first use."""
    root = os.environ.get("PRIMETPU_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "primetpu", "warm"
    )
    os.makedirs(root, exist_ok=True)
    return root


def _geometry_hash(cfg) -> str:
    return hashlib.sha256(cfg.timing_normalized().to_json().encode()).hexdigest()


def _warm_payload(cfg, trace_fp: str) -> dict:
    """The step-count-independent part of the cache key."""
    from .state import knobs_from_config

    kn = knobs_from_config(cfg, "cpu")
    payload = {
        "format": _FORMAT,
        "trace": str(trace_fp),
        "geom": _geometry_hash(cfg),
        "knobs": {k: v.numpy().tolist() for k, v in kn._asdict().items()},
    }
    if (
        float(cfg.fault_flip_l1) > 0.0
        or float(cfg.fault_flip_llc) > 0.0
        or float(cfg.fault_due_rate) > 0.0
    ):
        payload["ecc"] = {
            "seed": int(cfg.fault_seed),
            "flip_l1": float(cfg.fault_flip_l1),
            "flip_llc": float(cfg.fault_flip_llc),
            "due_rate": float(cfg.fault_due_rate),
        }
    return payload


def warm_cfg_key(cfg, trace_fp: str) -> str:
    """Hash of the step-independent key inputs: the sidecar index key
    `find_warm_states` scans by."""
    blob = json.dumps(_warm_payload(cfg, trace_fp), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def warm_key(cfg, trace_fp: str, steps: int) -> str:
    """The full content address of a warm entry: the step-independent
    payload + the fault-schedule prefix (events with step < steps) +
    steps."""
    payload = _warm_payload(cfg, trace_fp)
    payload["events"] = sorted(
        tuple(int(x) for x in e)
        for e in getattr(cfg, "fault_events", ()) or ()
        if int(e[0]) < int(steps)
    )
    payload["steps"] = int(steps)
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _warm_paths(root: str, key: str) -> tuple[str, str]:
    return os.path.join(root, f"{key}.npz"), os.path.join(root, f"{key}.json")


def save_warm_state(root: str, cfg, trace_fp: str, steps: int, snap: dict) -> str:
    """Write a warm entry (atomic npz + JSON sidecar) and LRU-prune.

    `snap` is the dict a prefix run produces and `FleetEngine.fork_element`
    takes: {state, cycle_base, steps_run, host_counters}. Returns the
    key."""
    key = warm_key(cfg, trace_fp, steps)
    os.makedirs(root, exist_ok=True)
    npz_path, meta_path = _warm_paths(root, key)
    arrays = _state_arrays(snap["state"])
    arrays["host_counters"] = np.stack(
        [snap["host_counters"][k] for k in COUNTER_NAMES]
    )
    atomic_save_npz(
        npz_path,
        format=np.int64(_FORMAT),
        warm=np.int64(1),
        steps=np.int64(steps),
        cycle_base=np.int64(snap["cycle_base"]),
        steps_run=np.int64(snap["steps_run"]),
        trace_sha=np.frombuffer(str(trace_fp).encode(), dtype=np.uint8),
        **arrays,
    )
    meta = {
        "cfg_key": warm_cfg_key(cfg, trace_fp),
        "key": key,
        "trace_sha": str(trace_fp),
        "steps": int(steps),
    }
    # writer-unique temp name, as in atomic_save_npz: concurrent sweeps
    # warming one entry must not rename each other's sidecar away
    fd, tmp = tempfile.mkstemp(
        dir=root, prefix=os.path.basename(meta_path) + ".", suffix=".tmp",
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta_path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    prune_warm_cache(root)
    return key


def load_warm_state(root: str, key: str, cfg, trace_fp: str, steps: int,
                    device="cpu") -> dict:
    """Load and verify a warm entry; returns the fork dict with its state
    on `device`.

    Raises FileNotFoundError when absent (a plain miss), CheckpointCorrupt
    when the file is torn or tampered (the caller recomputes), and
    ValueError when the entry doesn't match the requested identity (also
    recompute)."""
    npz_path, _ = _warm_paths(root, key)
    z = load_verified_npz(npz_path)
    _require_format(z, npz_path)
    if "warm" not in z:
        raise ValueError(f"{npz_path}: not a warm-state cache entry")
    if int(z["steps"]) != int(steps):
        raise ValueError(
            f"{npz_path}: entry holds {int(z['steps'])} steps, wanted {steps}"
        )
    if bytes(z["trace_sha"]).decode() != str(trace_fp):
        raise ValueError(f"{npz_path}: entry trace does not match workload")
    if warm_key(cfg, trace_fp, steps) != key:
        raise ValueError(f"{npz_path}: entry key does not match workload")
    if z["state_counters"].shape[0] != len(COUNTER_NAMES):
        raise ValueError(
            f"{npz_path}: incompatible counter-row count "
            f"{z['state_counters'].shape[0]}"
        )
    try:
        os.utime(npz_path, None)  # LRU touch: eviction follows use
    except OSError:
        pass
    hc = z["host_counters"]
    return {
        "state": _state_from(z, cfg, device),
        "cycle_base": np.int64(z["cycle_base"]),
        "steps_run": np.int64(z["steps_run"]),
        "host_counters": {
            k: hc[i].astype(np.int64) for i, k in enumerate(COUNTER_NAMES)
        },
    }


def find_warm_states(root: str, cfg, trace_fp: str) -> list[tuple[int, str]]:
    """Entries reusable by (cfg, trace): sidecars whose cfg_key matches
    and whose full key recomputes identically under this cfg (which checks
    the fault-schedule prefix below the entry's step count). Returns
    [(steps, key)] deepest first; unreadable sidecars are skipped (the npz
    CRC check still guards the load)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    want_cfg = warm_cfg_key(cfg, trace_fp)
    out = []
    for name in names:
        if not name.endswith(".json") or name.endswith(".json.tmp"):
            continue
        try:
            with open(os.path.join(root, name)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        if meta.get("cfg_key") != want_cfg:
            continue
        steps = int(meta.get("steps", 0))
        key = str(meta.get("key", ""))
        if steps > 0 and key and warm_key(cfg, trace_fp, steps) == key:
            out.append((steps, key))
    out.sort(key=lambda sk: (-sk[0], sk[1]))
    return out


def prune_warm_cache(root: str, max_bytes: int | None = None) -> int:
    """Evict least-recently-used entries until the cache fits under
    `max_bytes`. Returns the number of entries removed. Hits refresh
    mtime, so mtime order is use order.

    The kernel build cache (sim/exec_cache.py) shares this budget: its
    `root/exec/*.bin` entries, the port's and any the JAX package's
    executable cache wrote there, are one LRU pool with the warm `.npz`
    entries. Budget resolution:
    explicit `max_bytes` > the process-wide `--cache-budget`
    (diskpressure.budget()) > $PRIMETPU_CACHE_MAX_BYTES > 2 GiB."""
    if max_bytes is None:
        max_bytes = diskpressure.budget()
    if max_bytes is None:
        max_bytes = int(
            os.environ.get("PRIMETPU_CACHE_MAX_BYTES", _WARM_DEFAULT_MAX_BYTES)
        )
    entries = []
    pools = [(root, ".npz")]
    exec_root = os.path.join(root, "exec")
    if os.path.isdir(exec_root):
        pools.append((exec_root, ".bin"))
    for pool_root, suffix in pools:
        try:
            names = os.listdir(pool_root)
        except OSError:
            continue
        for name in names:
            if not name.endswith(suffix):
                continue
            path = os.path.join(pool_root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path, suffix))
    total = sum(e[1] for e in entries)
    entries.sort()  # oldest first across both pools
    removed = 0
    for _mtime, size, path, suffix in entries:
        if total <= max_bytes:
            break
        for victim in (path, path[: -len(suffix)] + ".json"):
            try:
                os.unlink(victim)
            except OSError:
                pass
        total -= size
        removed += 1
    return removed
