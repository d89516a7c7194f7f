"""Step-time fault injection: scheduled events, ECC draws, the dead-core
scrub and link-detour penalties (DESIGN.md §12), the JAX package's
`faults/inject.py` for the port.

`sim.engine.step` calls these under `cfg.faults_enabled`, as eager torch
ops on the state's device that make no host synchronisation. Two things
differ from the JAX package, neither in result:

- `scrub_dead` works IN PLACE on the directory: it is the whole of
  `dirm` (805 MB at the headline, 9.66 GB at rung 4), which a copy would
  double.
- The JAX step guards the scrub with a device-side `lax.cond` on "some
  core died this step". The port decides on the host instead, without a
  sync: the PRNG is a pure function of (seed, step, site), so
  `kill_possible` tells from the schedule and the seed on which steps a
  core can die, and the engine runs the scrub on those steps only. On a
  candidate step where nobody dies (the core had already ended or died)
  the scrub is the identity, as the JAX false branch is.

The kernels never see a fault (the JAX package's fault-lane contract,
`kernels/step_kernels.py`): the scrub rewrites `dirm` before the probe
and the local runs read it, dead cores leave the lane predicates, and the
detour latencies and counter deltas are added around the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    FAULT_LINK_FAIL,
    MachineConfig,
)
from ..noc import topology
from ..sim.state import llc_meta_width
from .prng import DUE_SALT, site_hash, site_hash_np

_i32 = torch.int32


def _max_drop(base, idx, src):
    """base.at[idx].max(src, mode="drop") with idx == len(base) as the
    dropped lane: the table has one sentinel slot, sliced off."""
    ext = torch.cat([base, base.new_zeros(1)])
    ext.scatter_reduce_(0, idx.long(), src, "amax")
    return ext[:-1]


def fire_events(cfg: MachineConfig, fs, step_no):
    """Apply this step's scheduled events: (kill_sched [C] int32 0/1,
    link_dead [NL], link_extra [NL]). Duplicate events max together;
    padding rows (ev_step == -1) never fire."""
    C = cfg.n_cores
    NL = cfg.n_tiles * 4
    fire = fs.ev_step == step_no
    ones = torch.ones_like(fs.ev_a)
    kill_t = fire & (fs.ev_kind == FAULT_CORE_FAILSTOP)
    kill_sched = _max_drop(
        torch.zeros_like(fs.core_dead), torch.where(kill_t, fs.ev_a, C), ones
    )
    lf = fire & (fs.ev_kind == FAULT_LINK_FAIL)
    link_dead = _max_drop(fs.link_dead, torch.where(lf, fs.ev_a, NL), ones)
    ld = fire & (fs.ev_kind == FAULT_LINK_DEGRADE)
    link_extra = _max_drop(fs.link_extra, torch.where(ld, fs.ev_a, NL), fs.ev_b)
    return kill_sched, link_dead, link_extra


def ecc_step(cfg: MachineConfig, fs, step_no):
    """This step's transient-flip draws under the SECDED model.

    One flip draw per L1 (site = core id) and per LLC bank (site = C +
    bank), and a salted second draw classifying each flip as single-bit
    (corrected: counted, no architectural effect) or double-bit
    (detected-uncorrectable), all four in one [2, C + B] hash. Returns
    (corrected [C], due [C], l1_due [C] bool): LLC-bank draws count at core
    bank % C (an add with duplicate targets when B > C); only an L1 DUE
    can escalate to a fail-stop of its core."""
    C, B = cfg.n_cores, cfg.n_banks
    dev = fs.core_dead.device
    site = torch.arange(C + B, dtype=torch.int64, device=dev)
    salt = torch.arange(2, dtype=torch.int64, device=dev)[:, None] * DUE_SALT
    h = site_hash(fs.seed, step_no, site, salt)  # [flip draw, DUE draw]
    thr = torch.cat([fs.flip_l1.expand(C), fs.flip_llc.expand(B)])
    flip = h[0] < thr
    due = flip & (h[1] < fs.due_rate)
    both = torch.stack([flip & ~due, due]).to(_i32)  # [corrected, due]
    per_core = both[:, :C].clone()
    bank_core = torch.arange(B, dtype=torch.int64, device=dev) % C
    per_core.index_add_(1, bank_core, both[:, C:])
    return per_core[0], per_core[1], due[:C]


def kill_possible(cfg: MachineConfig, fs_host: dict, steps) -> np.ndarray:
    """[len(steps)] bool: the steps on which phase -1 can kill a core, from
    the host's copy of the FaultState (`fs_host`: numpy values of seed,
    ev_step, ev_kind, flip_l1 and due_rate): a scheduled core_failstop, or
    under `fault_due_failstop` an L1 flip classified DUE at some core.
    Whether that core is still alive is the device's business."""
    steps = np.asarray(steps, np.int64)
    sched = fs_host["ev_step"][fs_host["ev_kind"] == FAULT_CORE_FAILSTOP]
    hit = np.isin(steps, sched)
    flip, due = int(fs_host["flip_l1"]), int(fs_host["due_rate"])
    if cfg.fault_due_failstop and flip and due:
        seed = int(fs_host["seed"])
        cores = np.arange(cfg.n_cores)[None, :]
        block = max(1, (1 << 20) // cfg.n_cores)
        for lo in range(0, len(steps), block):
            s = steps[lo : lo + block, None]
            h = site_hash_np(seed, s, cores)
            d = site_hash_np(seed, s, cores, DUE_SALT)
            hit[lo : lo + block] |= ((h < flip) & (d < due)).any(1)
    return hit


def scrub_dead(cfg: MachineConfig, dirm, lock_holder, kill_now):
    """Remove this step's freshly killed cores (`kill_now` [C] 0/1) from
    the coherence fabric, IN PLACE on `dirm`; returns (lock_holder,
    wb [C]).

    - Sharer bits: every sharer word drops the killed cores' bits (fail-
      stop requires sharer_group == 1, so bit == core id).
    - Owners: entries owned by a killed core lose their owner. Under
      "writeback" the line survives in the LLC and the dead owner is
      charged one writeback per owned line; under "drop" the way's tag
      goes to -1 and its sharer words are cleared.
    - Locks: slots held by a killed core are released.

    An empty kill set changes nothing and returns wb = 0."""
    C = cfg.n_cores
    W2 = cfg.llc.ways
    NW = cfg.n_sharer_words
    MW = llc_meta_width(cfg)
    R = dirm.shape[0]
    dev = dirm.device
    arange_c = torch.arange(C, dtype=_i32, device=dev)
    kill_b = kill_now != 0
    # killed-core bits packed as words (distinct bits: the sum is the OR)
    bits = torch.zeros(NW * 32, dtype=_i32, device=dev)
    bits[:C] = torch.where(kill_b, 1 << (arange_c & 31), 0)
    killw = bits.view(NW, 32).sum(1, dtype=_i32)
    sh = dirm[:, MW:]
    sh.bitwise_and_(~killw.repeat(W2))
    meta = dirm[:, : 2 * W2].view(R, W2, 2)
    tag, own = meta[..., 0], meta[..., 1]
    downer = (own >= 0) & kill_b[own.clamp(0, C - 1).long()]
    if cfg.fault_dead_policy == "drop":
        tag.masked_fill_(downer, -1)
        sh.view(R, W2, NW).masked_fill_(downer[..., None], 0)
        wb = torch.zeros(C, dtype=_i32, device=dev)
    else:
        # masked lanes add 0 at a spread of cores, not all at one slot
        spread = torch.arange(R * W2, device=dev).view(R, W2) % C
        wb = torch.zeros(C, dtype=_i32, device=dev).index_add_(
            0, torch.where(downer, own.long(), spread).flatten(),
            downer.flatten().to(_i32),
        )
    own.masked_fill_(downer, -1)
    held_dead = (lock_holder >= 0) & kill_b[lock_holder.clamp(0, C - 1).long()]
    return torch.where(held_dead, -1, lock_holder), wb


@functools.lru_cache(maxsize=8)
def detour_table(cfg: MachineConfig, device: torch.device) -> torch.Tensor:
    """`topology.detour_hops_table(cfg)` as an int32 tensor on `device`,
    uploaded once per (config, device) as the state names it (`cuda:0`
    and `cuda` are different keys); the engine builds it before any
    step."""
    return torch.from_numpy(topology.detour_hops_table(cfg)).to(device)


def leg_fault_penalty(cfg: MachineConfig, fs, kn, atile, btile):
    """Fault penalty of the one-way legs atile -> btile: (extra cycles,
    extra hops, rerouted 0/1) per lane, the vectorized twin of
    `noc.topology.detour_stats`. Each dead link on the route detours at
    the topology's extra-hop cost, paying (link + router) per extra hop;
    each live degraded link adds its extra cycles."""
    p = topology.path_links(cfg, atile, btile)  # [C, H]
    ok = p >= 0
    pc = torch.where(ok, p, 0).long()
    dead = torch.where(ok, fs.link_dead[pc], 0)
    dh = detour_table(cfg, fs.link_dead.device)[pc] * dead
    extra = torch.where(ok & (dead == 0), fs.link_extra[pc], 0)
    d = dh.sum(1, dtype=_i32)
    lat = d * (kn.link_lat + kn.router_lat) + extra.sum(1, dtype=_i32)
    return lat, d, (dead.sum(1, dtype=_i32) > 0).to(_i32)
