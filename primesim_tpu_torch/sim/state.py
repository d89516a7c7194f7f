"""Machine state: the whole simulated machine as int32 torch tensors.

The same fields and the same layouts as the JAX package's
`sim/state.py`, so that states compare field by field and cross between
the packages (`convert.py`): the five-plane L1 `[C, 5*W1*S1]` and the
fused directory rows `dirm [B*S2, dirm_width]` whose metadata prefix is
padded to a 128-column multiple before the packed sharer words. This
slice has no fault-injection state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.machine import MachineConfig
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
    )
