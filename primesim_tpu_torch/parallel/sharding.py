"""Multi-device sharding of the simulated machine over a tile mesh: the
JAX package's `parallel/sharding.py` for the port.

The JAX package lays one machine over a one-process `jax.sharding.Mesh`
with the axis "tiles" and lets XLA's SPMD partitioner insert the
cross-device traffic. Torch has no such partitioner, so the port keeps
the state as shards on a list of torch devices and writes the
cross-shard moves itself:

- a `TileMesh` is an ordered list of shard ids, each mapped to a
  `torch.device`. Several ids may map to one device (four shards on one
  card), the way the JAX tests' virtual CPU devices all sit on one host;
- `state_pspecs()` is the JAX placement table, field for field:
  core-axis fields (clocks, pointers, the L1, the sync flags, the
  prefetcher, the counters' core axis, the CPI vector, the dead-core
  mask) shard by core, `dirm` and `dram_free` by bank (`dirm`'s rows are
  bank-major, slot = bank * S2 + set, so a bank block is a contiguous
  row block) and the rest is replicated on the mesh's lead device;
- `shard_state` turns a whole state into that form (`sim.state.Shards`
  fields), `unshard_state` turns it back (checkpoints and host reads);
- every tensor that crosses shards goes through the mesh's `exchange`
  (`LocalExchange` here, `distributed.GroupExchange` over a process
  group), which records its name, shape and bytes in `MOVES`, beside
  `kernels.build.LAUNCHES`.

Device loss is modeled as in the JAX package: a process-local set of
revoked ids that `healthy_devices()` filters out of the visible ones.
The visible devices are the cards (`torch.cuda.device_count()`); on the
CPU they are the count that `XLA_FLAGS=--xla_force_host_platform_device_
count=N` names (1 without it), so the CLI's checks read the same count
as the JAX package's under the tests' 8 virtual devices.
`virtual_devices(n, device)` declares n ids on one device instead, which
is how one card hosts a mesh that can lose a shard.
"""

from __future__ import annotations

import math
import os
import re
from typing import NamedTuple

import torch

from ..faults.schedule import FaultState
from ..sim.state import MachineState, Shards, TimingKnobs

AXIS = "tiles"


class MeshDevice(NamedTuple):
    """One shard slot of a mesh: its id (the revocation registry's key)
    and the torch device it lives on."""

    id: int
    device: torch.device

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type


# ---- visible and revoked devices (DESIGN.md §26)

_REVOKED: set = set()
_VIRTUAL: list | None = None


def host_device_count() -> int:
    """The CPU's device count: XLA_FLAGS' forced host-platform count, as
    the JAX package's CPU backend reads it, else 1."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def virtual_devices(n: int | None, device=None) -> None:
    """Make `n` shard ids on `device` the visible devices of this process
    (n = None: the platform's own again)."""
    global _VIRTUAL
    _VIRTUAL = None if n is None else [
        MeshDevice(i, torch.device(device)) for i in range(int(n))
    ]


def visible_devices(platform: str | None = None) -> list:
    """The devices a mesh may use: the virtual ones if declared, else the
    cards (platform "gpu", the default when CUDA is available), else the
    CPU's host-platform count."""
    if _VIRTUAL is not None:
        return list(_VIRTUAL)
    if platform is None:
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    if platform == "gpu":
        return [MeshDevice(i, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [MeshDevice(i, torch.device("cpu")) for i in range(host_device_count())]


def revoke_devices(ids) -> None:
    """Mark device ids as lost (chaos injection / test hook)."""
    _REVOKED.update(int(i) for i in ids)


def restore_devices(ids=None) -> None:
    """Heal revoked devices (all of them when `ids` is None)."""
    if ids is None:
        _REVOKED.clear()
    else:
        _REVOKED.difference_update(int(i) for i in ids)


def healthy_devices(platform: str | None = None) -> list:
    """Currently-visible devices minus the revoked set."""
    return [d for d in visible_devices(platform) if d.id not in _REVOKED]


class DeviceMeshError(ValueError):
    """Typed `--devices N` validation failure (CLI exit 2, structured
    ``{"error": ...}`` on stderr), raised before anything is placed."""

    def __init__(self, detail: str, *, devices: int, visible: int | None = None):
        super().__init__(detail)
        self.devices = devices
        self.visible = visible

    def location(self):
        loc = {"devices": self.devices}
        if self.visible is not None:
            loc["visible"] = self.visible
        return loc


def validate_devices(cfg, n_devices: int, platform: str | None = None) -> None:
    """Validate a `--devices N` request against the machine geometry and
    the visible devices, with the JAX package's checks and texts."""
    if n_devices < 1:
        raise DeviceMeshError(
            f"--devices must be >= 1, got {n_devices}", devices=n_devices
        )
    visible = len(visible_devices(platform))
    if n_devices > visible:
        raise DeviceMeshError(
            f"--devices {n_devices} exceeds the {visible} visible "
            f"device(s); set XLA_FLAGS=--xla_force_host_platform_device_"
            f"count={n_devices} for a virtual CPU mesh",
            devices=n_devices,
            visible=visible,
        )
    for name, extent in (("n_cores", cfg.n_cores), ("n_banks", cfg.n_banks)):
        if extent % n_devices != 0:
            raise DeviceMeshError(
                f"--devices {n_devices} does not divide {name}={extent}; "
                f"the {AXIS!r} mesh axis shards cores and banks evenly",
                devices=n_devices,
                visible=visible,
            )


def largest_valid_submesh(cfg, n_available: int) -> int:
    """Largest mesh size <= `n_available` that divides both n_cores and
    n_banks (1 always does); no device at all is a DeviceMeshError."""
    if n_available < 1:
        raise DeviceMeshError(
            "no healthy devices remain to host the mesh",
            devices=0,
            visible=n_available,
        )
    for n in range(int(n_available), 0, -1):
        if cfg.n_cores % n == 0 and cfg.n_banks % n == 0:
            return n
    return 1


# ---- the mesh


class TileMesh:
    """A 1-D mesh over the tile axis: `devices` (MeshDevice, mesh order),
    the shards this process holds (`local`, all of them in one process)
    and the `exchange` that moves tensors between shards. The lead
    device, the first local shard's, holds the replicated fields and
    runs the step's lane logic."""

    def __init__(self, devices, exchange=None, local=None):
        self.devices = list(devices)
        self.size = len(self.devices)
        self.local = list(range(self.size)) if local is None else list(local)
        self.exchange = LocalExchange(self) if exchange is None else exchange(self)

    @property
    def ids(self) -> list[int]:
        return [d.id for d in self.devices]

    @property
    def lead(self) -> torch.device:
        return self.devices[self.local[0]].device

    @property
    def platform(self) -> str:
        return self.devices[self.local[0]].platform

    def shard_device(self, k: int) -> torch.device:
        return self.devices[k].device


def tile_mesh(n_devices: int | None = None, devices=None) -> TileMesh:
    """1-D mesh over the tile axis: the first `n_devices` visible devices,
    or `devices` (MeshDevice, or torch devices whose ids are their
    positions)."""
    if devices is None:
        devices = visible_devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"tile_mesh: {n_devices} devices requested but only "
                    f"{len(devices)} visible"
                )
            devices = devices[:n_devices]
    devices = [d if isinstance(d, MeshDevice) else MeshDevice(i, torch.device(d))
               for i, d in enumerate(devices)]
    return TileMesh(devices)


# ---- the placement table


def state_pspecs() -> MachineState:
    """The partition spec of every MachineState field, the JAX package's
    `state_pspecs()` as tuples: ("tiles",) shards the leading axis,
    (None, "tiles") the second and () replicates."""
    core, rep = (AXIS,), ()
    return MachineState(
        cycles=core,
        ptr=core,
        l1=core,
        dirm=core,
        link_free=rep,
        dram_free=core,  # bank-axis, like the directory rows beside it
        lock_holder=rep,
        barrier_count=rep,
        barrier_time=rep,
        sync_flag=core,
        quantum_end=rep,
        step=rep,
        pf_line=core,
        pf_stride=core,
        pf_streak=core,
        counters=(None, AXIS),
        knobs=TimingKnobs(
            quantum=rep, cpi=core, l1_lat=rep, llc_lat=rep, link_lat=rep,
            router_lat=rep, dram_lat=rep, dram_service=rep, contention_lat=rep,
            prefetch_degree=rep, prefetch_lat=rep,
        ),
        faults=FaultState(
            seed=rep, core_dead=core, link_dead=rep, link_extra=rep,
            ev_step=rep, ev_kind=rep, ev_a=rep, ev_b=rep, flip_l1=rep,
            flip_llc=rep, due_rate=rep,
        ),
    )


def events_pspec() -> tuple:
    return (AXIS,)  # events [C, T, 4] sharded by core


def fleet_state_pspecs() -> MachineState:
    """state_pspecs() under the fleet's leading batch axis, which stays
    whole: cores and banks shard within each element."""
    return _map_specs(lambda spec: (None, *spec), state_pspecs())


def fleet_events_pspec() -> tuple:
    return (None, AXIS)  # events [B, C, T, 4]


def _map_specs(fn, specs):
    return type(specs)(*(
        _map_specs(fn, v) if hasattr(v, "_fields") else fn(v) for v in specs
    ))


def _place(mesh: TileMesh, x: torch.Tensor, spec: tuple):
    """One field laid out by its spec: a Shards of this process's blocks,
    or the whole tensor on the lead device."""
    if AXIS not in spec:
        return x.to(mesh.lead)
    axis = spec.index(AXIS) - x.dim()
    n = x.shape[axis]
    if n % mesh.size:
        raise DeviceMeshError(
            f"{mesh.size} shards do not divide an axis of {n}",
            devices=mesh.size,
        )
    blocks = x.chunk(mesh.size, axis)
    return Shards([blocks[k].to(mesh.shard_device(k)).contiguous() for k in mesh.local],
                  axis, mesh)


def _place_all(mesh, st, specs):
    return type(st)(*(
        _place_all(mesh, v, s) if hasattr(v, "_fields") else _place(mesh, v, s)
        for v, s in zip(st, specs)
    ))


def shard_state(mesh: TileMesh, st: MachineState) -> MachineState:
    """A solo state laid out over the mesh (a sharded state is first
    brought back whole, so a state moves between meshes)."""
    return _place_all(mesh, unshard_state(st), state_pspecs())


def shard_events(mesh: TileMesh, events: torch.Tensor) -> Shards:
    if isinstance(events, Shards):
        events = events.mesh.exchange.full(events, events.mesh.lead)
    return _place(mesh, events, events_pspec())


def shard_fleet_state(mesh: TileMesh, st: MachineState) -> MachineState:
    return _place_all(mesh, unshard_state(st), fleet_state_pspecs())


def shard_fleet_events(mesh: TileMesh, events: torch.Tensor) -> Shards:
    if isinstance(events, Shards):
        events = events.mesh.exchange.full(events, events.mesh.lead)
    return _place(mesh, events, fleet_events_pspec())


def unshard_state(st: MachineState, device=None) -> MachineState:
    """The whole state on one device (`device`, else the mesh's lead
    device); an unsharded state is returned as it is."""
    def whole(v):
        if isinstance(v, Shards):
            return v.mesh.exchange.full(v, v.mesh.lead if device is None else device)
        if isinstance(v, tuple):
            return type(v)(*(whole(x) for x in v))
        return v if device is None else v.to(device)

    return whole(st)


# ---- the exchange

# name -> {"moves": n, "bytes": b, "shape": the largest move's shape};
# `LocalExchange._to` and `distributed.GroupExchange` are the writers
MOVES: dict[str, dict] = {}


def reset_moves() -> None:
    MOVES.clear()


def record(name: str, x: torch.Tensor) -> None:
    m = MOVES.setdefault(name, {"moves": 0, "bytes": 0, "shape": []})
    m["moves"] += 1
    m["bytes"] += x.numel() * x.element_size()
    if x.numel() > math.prod(m["shape"]):
        m["shape"] = list(x.shape)


class LocalExchange:
    """Cross-shard moves of a mesh whose shards are all in this process.
    Every method takes this process's shards in mesh order and records
    each tensor it moves. Lane tensors are [B, C, ...] (the batch axis
    first), so the core axis is 1 unless named."""

    def __init__(self, mesh: TileMesh):
        self.mesh = mesh

    def _to(self, name: str, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        record(name, x)
        return x.to(dev, non_blocking=True)

    def _allsum(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The sum over processes of each process's partial: there is one."""
        return x

    def _allcat(self, name: str, x: torch.Tensor, axis: int) -> torch.Tensor:
        return x

    def gather(self, name: str, parts, axis: int = 1) -> torch.Tensor:
        """The whole lane tensor on the lead device from its shards."""
        lead = self.mesh.lead
        return self._allcat(name, torch.cat([self._to(name, p, lead) for p in parts], axis), axis)

    def split(self, name: str, x: torch.Tensor, axis: int = 1) -> list:
        """A whole lane tensor on the lead device cut into this process's
        shards, each on its shard's device."""
        m = self.mesh
        blocks = x.chunk(m.size, axis)
        return [self._to(name, blocks[k], m.shard_device(k)) for k in m.local]

    def bcast(self, name: str, x: torch.Tensor) -> list:
        """A replicated tensor of the lead device, on every shard's device."""
        m = self.mesh
        return [self._to(name, x, m.shard_device(k)) for k in m.local]

    def sum(self, name: str, parts) -> torch.Tensor:
        """The sum over every shard of per-shard partials, on the lead."""
        lead = self.mesh.lead
        out = self._to(name, parts[0], lead).clone()
        for p in parts[1:]:
            out += self._to(name, p, lead)
        return self._allsum(name, out)

    def rows(self, name: str, dirm_parts, idx_parts) -> list:
        """Directory rows by request: core shard k asks for rows
        `idx_parts[k]` ([B, Cs, K] global slots) and gets them back
        [B, Cs, K, DW] on its device. The requests go to every bank
        shard, each answers the rows it owns, and the answers are merged
        (every slot has one owner); the rows come back split by core
        shard."""
        m = self.mesh
        idx = self.gather(name + ".ids", idx_parts).long()
        R = dirm_parts[0].shape[-2]
        owner, loc = idx // R, idx % R
        ib = torch.arange(idx.shape[0], device=idx.device).view(-1, *[1] * (idx.dim() - 1))
        acc = None
        for b, d in zip(m.local, dirm_parts):
            req = self._to(name + ".ids", torch.stack([owner, loc]), d.device)
            ans = d[ib.to(d.device), req[1]]
            ans = self._to(name, torch.where((req[0] == b)[..., None], ans, 0), m.lead)
            acc = ans if acc is None else torch.where((owner == b)[..., None], ans, acc)
        return self.split(name, self._allsum(name, acc))

    def add_rows(self, name: str, dirm_parts, slot_parts, row_parts) -> None:
        """Each core shard's delta rows ([B, Cs, DW], `row_parts`) added
        to the rows `slot_parts` ([B, Cs], a slot outside the directory
        adds nothing) of their owner bank shards, in place. The adds wrap
        like int32, so their order does not matter."""
        m = self.mesh
        slots = self.gather(name + ".ids", slot_parts).long()
        rows = self.gather(name, row_parts)
        R, DW = dirm_parts[0].shape[-2], dirm_parts[0].shape[-1]
        ib = torch.arange(slots.shape[0], device=slots.device)[:, None]
        owner, flat = slots // R, ib * R + slots % R
        for b, d in zip(m.local, dirm_parts):
            req = self._to(name + ".ids", torch.stack([owner, flat]), d.device)
            r = torch.where((req[0] == b)[..., None], self._to(name, rows, d.device), 0)
            d.view(-1, DW).index_add_(0, req[1].flatten(), r.reshape(-1, DW))

    def full(self, x: Shards, device) -> torch.Tensor:
        """The whole field of a Shards on `device` (host reads and
        checkpoints; never inside a step)."""
        return torch.cat([p.to(device) for p in x], x.axis)

    def host(self, x: Shards) -> torch.Tensor:
        return self.full(x, torch.device("cpu"))
