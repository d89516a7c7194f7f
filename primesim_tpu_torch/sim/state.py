"""Machine state: the whole simulated machine as int32 torch tensors.

The same fields and the same layouts as the JAX package's
`sim/state.py`, so that states compare field by field and cross between
the packages (`convert.py`): the five-plane L1 `[C, 5*W1*S1]` and the
fused directory rows `dirm [B*S2, dirm_width]` whose metadata prefix is
padded to a 128-column multiple before the packed sharer words, and the
fault-injection state `faults` (faults/schedule.py::FaultState), always
present and read by the step only under `cfg.faults_enabled`.

The step (`sim/engine.py::step`) works on a BATCHED state: every field,
nested knobs and fault state included, gains a leading element axis
[B, ...], so `TimingKnobs` fields are [B] and `cpi` is [B, C]. A solo
state is one element: `batch_state` and `solo_state` turn one into the
other as views (no copy), `stack_states` builds a batch from solo
states and `element_state` slices element i back out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.machine import MachineConfig
from ..faults.schedule import FaultState, fault_state_from_config
from ..stats.counters import COUNTER_NAMES

# MESI encoding (shared with the JAX package and its golden model)
I, S, E, M = 0, 1, 2, 3
# MOESI's Owned: derived at classification time, never stored in an L1
O = 4


def llc_meta_width(cfg: MachineConfig) -> int:
    """Width of the metadata prefix of a `dirm` row: 4*W2 data columns
    (tag/owner pairs, lru, invalidation epoch) rounded up to a multiple
    of 128."""
    return ((4 * cfg.llc.ways + 127) // 128) * 128


def dirm_width(cfg: MachineConfig) -> int:
    """Full `dirm` row width: metadata prefix + W2*NW packed sharer
    words."""
    return llc_meta_width(cfg) + cfg.llc.ways * cfg.n_sharer_words


class TimingKnobs(NamedTuple):
    """Per-simulation timing values as int32 device scalars (and the
    per-core CPI vector), as the JAX package carries them in its state."""

    quantum: torch.Tensor  # []
    cpi: torch.Tensor  # [C]
    l1_lat: torch.Tensor  # []
    llc_lat: torch.Tensor  # []
    link_lat: torch.Tensor  # []
    router_lat: torch.Tensor  # []
    dram_lat: torch.Tensor  # []
    dram_service: torch.Tensor  # []
    contention_lat: torch.Tensor  # []
    prefetch_degree: torch.Tensor  # []
    prefetch_lat: torch.Tensor  # []


def knobs_from_config(cfg: MachineConfig, device) -> TimingKnobs:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return TimingKnobs(
        quantum=i32(cfg.quantum),
        cpi=i32(cfg.core.cpi_vector(cfg.n_cores)),
        l1_lat=i32(cfg.l1.latency),
        llc_lat=i32(cfg.llc.latency),
        link_lat=i32(cfg.noc.link_lat),
        router_lat=i32(cfg.noc.router_lat),
        dram_lat=i32(cfg.dram_lat),
        dram_service=i32(cfg.dram_service),
        contention_lat=i32(cfg.noc.contention_lat),
        prefetch_degree=i32(cfg.prefetch_degree),
        prefetch_lat=i32(cfg.prefetch_lat),
    )


class MachineState(NamedTuple):
    """Field notes are in the JAX package's `sim/state.py`."""

    cycles: torch.Tensor  # [C] per-core clock (epoch-relative)
    ptr: torch.Tensor  # [C] next trace event index
    l1: torch.Tensor  # [C, 5*W1*S1] planes tag/state/lru/ptr/epoch
    dirm: torch.Tensor  # [B*S2, dirm_width(cfg)]
    link_free: torch.Tensor  # [n_tiles*4] router NoC link clocks (zero without it)
    dram_free: torch.Tensor  # [B] DRAM controller clocks (zero without the queue)
    lock_holder: torch.Tensor  # [lock_slots] core id or -1
    barrier_count: torch.Tensor  # [barrier_slots]
    barrier_time: torch.Tensor  # [barrier_slots]
    sync_flag: torch.Tensor  # [C]
    quantum_end: torch.Tensor  # []
    step: torch.Tensor  # []
    pf_line: torch.Tensor  # [C] stride prefetcher: last trained line
    pf_stride: torch.Tensor  # [C]
    pf_streak: torch.Tensor  # [C]
    counters: torch.Tensor  # [n_counters, C]
    knobs: TimingKnobs
    faults: FaultState


def map_state(fn, st: MachineState) -> MachineState:
    """`fn` applied to every tensor of the state, nested ones included."""
    return MachineState(*(
        type(v)(*(fn(x) for x in v)) if isinstance(v, tuple) else fn(v)
        for v in st
    ))


def batch_state(st: MachineState) -> MachineState:
    """A solo state as a batch of one (views)."""
    return map_state(lambda x: x.unsqueeze(0), st)


def solo_state(st: MachineState) -> MachineState:
    """The one element of a batch of one as a solo state (views)."""
    return element_state(st, 0)


def element_state(st: MachineState, i: int) -> MachineState:
    """Element i of a batched state, solo-shaped (views)."""
    return map_state(lambda x: x[i], st)


def leaves(st: MachineState) -> list:
    """Every tensor of the state, nested ones included, in field order."""
    return [x for v in st for x in (v if isinstance(v, tuple) else (v,))]


def stack_states(states, n: int) -> MachineState:
    """One batched state of `n` elements from an iterable of `n` solo
    states, each copied into its slot as it comes: from a generator only
    one solo state is alive at a time (eight headline directories are
    6.4 GB; stacking a list of them would need twice that)."""
    out = None
    for i, st in enumerate(states):
        if out is None:
            out = map_state(lambda x: x.new_empty((n, *x.shape)), st)
        for o, x in zip(leaves(out), leaves(st)):
            o[i].copy_(x)
    return out


def init_state(cfg: MachineConfig, device) -> MachineState:
    C, B = cfg.n_cores, cfg.n_banks
    FS = cfg.l1.sets * cfg.l1.ways
    W2 = cfg.llc.ways
    if cfg.quantum * cfg.n_cores >= 2**31:
        raise ValueError(
            "quantum * n_cores must be < 2^31 (conflict-key packing); "
            f"got {cfg.quantum} * {cfg.n_cores}"
        )

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    l1 = zeros(C, 5 * FS)
    l1[:, :FS] = -1  # tag plane; state plane is I = 0
    dirm = zeros(B * cfg.llc.sets, dirm_width(cfg))
    dirm[:, : 2 * W2] = -1  # tag/owner pairs
    return MachineState(
        cycles=zeros(C),
        ptr=zeros(C),
        l1=l1,
        dirm=dirm,
        link_free=zeros(cfg.n_tiles * 4),
        dram_free=zeros(B),
        lock_holder=full((cfg.lock_slots,), -1),
        barrier_count=zeros(cfg.barrier_slots),
        barrier_time=zeros(cfg.barrier_slots),
        sync_flag=zeros(C),
        quantum_end=full((), cfg.quantum),
        step=zeros(),
        pf_line=zeros(C),
        pf_stride=zeros(C),
        pf_streak=zeros(C),
        counters=zeros(len(COUNTER_NAMES), C),
        knobs=knobs_from_config(cfg, device),
        faults=fault_state_from_config(cfg, device),
    )
