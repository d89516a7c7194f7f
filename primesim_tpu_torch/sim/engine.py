"""The simulation engine: one eager PyTorch step and its host driver.

`step` is the JAX package's `sim/engine.py::step` for every
configuration of its one-device run path: MESI or MOESI's derived Owned
state on a mesh, torus or ring NoC (`noc.topology`), with a full-map
sharer vector, dense or chunked, or a coarse one (`sharer_group` > 1:
group bits, the epoch guard, no read joins, the group-table reductions
of `_group_tables`), with or without NoC contention (tile, link or router
model), the DRAM controller queue, the stride prefetcher and fault
injection (`faults/`: phase -1's scheduled events, ECC draws and dead-core
scrub, the dead-core masks, link detours, barrier relief), taking the
Pallas branch wherever the JAX step has one. Its kernels are
`kernels.step_kernels.probe_classify` (phase 1), `kernels.reductions.
sharer_reductions` (phase 3), `kernels.router_kernels.router_cascade`
(the router model's cascade) and `kernels.step_kernels.commit_step`
(phase 4.A). The probe reads the directory itself, the commit
updates the L1, the directory and the counters in place, and the cascade
reads the link clocks at the live hops and scatter-maxes its departures
itself; torch keeps the router's `base` scatter-min and the sort-based
FIFO ranks (`ops.ranking`). Faults stay outside the kernels: the scrub
rewrites `dirm` in place before the probe and the local runs read it.
The step issues no host synchronisation: every scalar it needs stays on
the device, and the host tells it whether to run the scrub.

The results are the JAX engine's, bit for bit: the same per-core
cycles, counters and state fields (tests/test_torch_engine.py).

The step is batch-first: it advances B independent simulations of one
geometry (a fleet, `sim/fleet.py`) through one set of launches, every
state field with a leading element axis and the timing knobs per
element. Every reduction, scatter and sort stays inside its element
(per-element sentinel slots, row-wise sorts), and each kernel takes the
batch in one launch. A solo state runs as a batch of one.

`Engine` is the host driver of one simulation. After each chunk of
`chunk_steps` steps it drains the int32 step counters into int64 host
counters and rebases the clocks by whole quanta (`drain_rebase`, shared
with the fleet), with one host synchronisation per chunk. Dead
cores count as done and do not bound the rebase. It knows the step
number on the host and, from the fault schedule and seed, the steps on
which a core can die (`faults.inject.kill_possible`): the scrub runs on
those steps only.

Overlapped dispatch (`Engine.overlap`, `FleetEngine.overlap`): after a
committed chunk k the engine enqueues chunk k+1 (`prefetch`) before the
caller's host work (snapshots, chains, journal records) reads chunk k's
state. The port's step is not functional (the commit and the scrub
write the L1, the directory and the counters in place), so the
speculated chunk runs on a device copy of the committed state; on a card
it runs on a side stream, ordered after the committed work, so that a
read of chunk k's state does not queue behind it. The next chunk adopts
the result only when the committed state is still the object it was
speculated from (and the chunk size the same): state surgery replaces
the state or drops the speculation (`discard_prefetch`).

`stream_loop` is the device loop of one window of a streamed trace
(`ingest/stream.py`): chunks sized on the host from the buffered events
so that the window ends at the step where the JAX package's
`stream_loop` ends it, with one host transfer a chunk.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config.machine import MachineConfig, check_port_supported
from ..faults import inject
from ..kernels import reductions, router_kernels, step_kernels
from ..kernels.step_kernels import (
    PL_HIT_ANY,
    PL_HIT_STATE,
    PL_HIT_WAY,
    PL_LLC_HAS,
    PL_LLC_HWAY,
    PL_LLC_VWAY,
    PL_OTHER_SH,
    PL_OWNER,
    PL_VIC_OWNER,
    PL_VIC_TAG,
)
from ..kernels.layouts import first_min, first_true, popcount, take
from ..noc import mesh, topology
from ..ops.ranking import lane_order, segmented_rank
from ..stats.counters import COUNTER_NAMES, zero_counters
from ..trace.format import (
    EV_BARRIER,
    EV_END,
    EV_INS,
    EV_LD,
    EV_LOCK,
    EV_ST,
    EV_UNLOCK,
    Trace,
    validate_sync,
)
from .state import (
    E,
    I,
    M,
    O,
    MachineState,
    S,
    Shards,
    batch_state,
    is_sharded,
    init_state,
    leaves,
    llc_meta_width,
    map_state,
    solo_state,
)

INT32_MAX = 2**31 - 1
_ACC_BITS = 30  # per-chunk counter increments must stay below 2^30
_i32 = torch.int32


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; no card and no explicit
    device is an error, never a quiet run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@functools.lru_cache(maxsize=4)
def _group_tables(cfg: MachineConfig):
    """Static per-(home tile, sharer group) tables of the coarse vector
    (sharer_group > 1), the JAX package's `_group_tables`: member count
    [n_groups], and the max one-way hops and summed round-trip hops over
    each group's members from each tile [n_tiles, n_groups], int32 numpy.
    Geometry only: the latency knobs are applied at the use site.
    Temporaries stay near 16M elements; cached per config (16384 tiles x
    256 groups x 64 members is 268M hop counts, seconds of numpy)."""
    G = cfg.sharer_group
    C = cfg.n_cores
    n_grp = cfg.n_sharer_groups
    nt = cfg.n_tiles
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    ids = np.arange(n_grp)[:, None] * G + np.arange(G)[None, :]  # [n_grp, G]
    valid = ids < C
    mt = (ids % nt).astype(np.int64)
    gx, gy = mt % mx, mt // mx
    members = valid.sum(1).astype(np.int32)
    max2hops = np.zeros((nt, n_grp), np.int32)
    sum2hops = np.zeros((nt, n_grp), np.int32)
    step = max(1, (1 << 24) // (n_grp * G))
    for lo in range(0, nt, step):
        t = np.arange(lo, min(lo + step, nt))
        tx, ty = (t % mx)[:, None, None], (t // mx)[:, None, None]
        h = topology.coord_hops(cfg.noc.topology, tx, ty, gx[None], gy[None], mx, my)
        max2hops[t] = np.where(valid[None], h, 0).max(2).astype(np.int32)
        sum2hops[t] = np.where(valid[None], 2 * h, 0).sum(2).astype(np.int32)
    return members, max2hops, sum2hops


@functools.lru_cache(maxsize=4)
def group_tables(cfg: MachineConfig, device: torch.device):
    """`_group_tables(cfg)` as int32 tensors on `device`, uploaded once
    per (config, device) as the step names it (`events.device`, e.g.
    cuda:0): the coarse-vector reductions' `tables`."""
    return tuple(torch.from_numpy(a).to(device) for a in _group_tables(cfg))


def _one_way(cfg: MachineConfig, tile_a, tile_b, kn):
    """One-way latency and hop count under cfg's topology, with the
    state's latency knobs."""
    h = topology.hops(cfg, tile_a, tile_b)
    return h * kn.link_lat + (h + 1) * kn.router_lat, h


@functools.lru_cache(maxsize=16)
def _iotas(C: int, Bn: int, device: torch.device):
    """The step's index vectors, made once per shape and device: core ids
    [C] int32 and int64, and element ids [B, 1] int64."""
    cid = torch.arange(C, dtype=_i32, device=device)
    return cid, cid.long(), torch.arange(Bn, device=device)[:, None]


def _scatter_min(n: int, idx, src):
    """jnp.full(n, INT32_MAX).at[idx].min(src, mode="drop") per element:
    [B, n] from idx, src [B, K], idx == n the dropped lane (each element's
    table has its own sentinel slot, sliced off)."""
    t = torch.full((idx.shape[0], n + 1), INT32_MAX, dtype=_i32, device=src.device)
    return t.scatter_reduce_(1, idx.long(), src, "amin")[:, :n]


def _scatter_drop(base, idx, src, reduce: str):
    """base.at[idx].<reduce>(src, mode="drop") per element: base [B, n],
    idx [B, K] with idx == n the dropped lane (a sentinel slot per
    element); `src` broadcasts against idx."""
    ext = torch.cat([base, base.new_zeros(base.shape[0], 1)], 1)
    if reduce == "set":
        ext.scatter_(1, idx.long(), src.expand(idx.shape).to(_i32))
    elif reduce == "add":
        ext.scatter_add_(1, idx.long(), src.expand(idx.shape).to(_i32))
    else:
        ext.scatter_reduce_(1, idx.long(), src, reduce)
    return ext[:, : base.shape[1]]


def _unbatch(out: MachineState, bst: MachineState, st: MachineState) -> MachineState:
    """`out`, a batch of one stepped from `bst = batch_state(st)`, as a
    solo state: a field the step passed through unchanged, or updated in
    place (the L1, the directory, the counters), is `st`'s own tensor."""
    same = {id(b): x for b, x in zip(leaves(bst), leaves(st))}
    return map_state(lambda x: same.get(id(x), x[0]), out)


def _devices(x) -> list:
    """The devices a tensor, or a field's shards, live on."""
    return sorted({p.device for p in x}, key=str) if isinstance(x, Shards) else [x.device]


def _batched(events):
    """A solo trace [C, T, 4] (or its shards) as a batch of one."""
    return events.map(lambda x: x[None]) if isinstance(events, Shards) else events[None]


def _zeros_like(x):
    return x.map(torch.zeros_like) if isinstance(x, Shards) else torch.zeros_like(x)


def _run_states(cfg: MachineConfig, l1, pmrows, pline, cid):
    """Phase 0.5's view of the run's events for a block of cores: the
    effective L1 state of each of the rl + 1 lines `pline` [B, C, rl+1]
    and the way it hits, from the cores' L1 rows `l1` [B, C, 5*W1*S1],
    their home directory rows `pmrows` [B, C, rl+1, DW] and the cores'
    global ids `cid` [C]. Returns (peff, plway), [B, C, rl+1] int32."""
    Bn, C, K = pline.shape
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW = cfg.n_sharer_words, llc_meta_width(cfg)
    FS = W1 * S1
    coarse = cfg.sharer_group > 1
    dev = l1.device
    g_c = cid >> (cfg.sharer_group.bit_length() - 1)  # sharer bit
    ps = pline & (S1 - 1)
    pcf = (torch.arange(W1, dtype=_i32, device=dev) * S1 + ps[..., None]).reshape(Bn, C, K * W1)
    KW = K * W1
    # tag and state planes, and under Dir-G the fill-time epoch plane
    pl_cols = [pcf, pcf + FS] + ([pcf + 4 * FS] if coarse else [])
    pts = l1.gather(2, torch.cat(pl_cols, -1).long())
    ptagr = pts[..., :KW].reshape(Bn, C, K, W1)
    pstater = pts[..., KW : 2 * KW].reshape(Bn, C, K, W1)
    pmeta = pmrows[..., : 2 * W2].reshape(Bn, C, K, W2, 2)
    pmhas, pmway = first_true(pmeta[..., 0] == pline[..., None])
    pown = take(pmeta[..., 1], pmway)
    pshw = take(pmrows[..., MW:], pmway * NW + (g_c[:, None] >> 5))
    pbit = ((pshw >> (g_c[:, None] & 31)) & 1) != 0
    plhit, plway = first_true((ptagr == pline[..., None]) & (pstater != I))
    plstate = take(pstater, plway)
    if coarse:
        # epoch guard: the group bit keeps this core's S copy only if no
        # sharer-clearing transition happened since its fill
        pleph = take(pts[..., 2 * KW :].reshape(Bn, C, K, W1), plway)
        pveph = take(pmrows[..., 3 * W2 : 4 * W2], pmway)
        pbit = pbit & (pveph == pleph)
    peff = torch.where(
        ~(plhit & pmhas),
        I,
        torch.where(pown == cid[:, None], plstate, torch.where(pbit, S, I)),
    )
    if cfg.coherence == "moesi":
        # derived Owned: this core owns the line at the home while other
        # sharers are recorded, so a run's store must arbitrate and the
        # effective E/M demotes to O. MOESI needs sharer_group == 1: pbit
        # is the self bit, and the popcount of the matched way's words
        # counts the sharers exactly.
        pw_cols = MW + pmway[..., None] * NW + torch.arange(NW, dtype=_i32, device=dev)
        ptot = popcount(pmrows.gather(3, pw_cols.long())).sum(-1, dtype=_i32)
        pothers = (ptot - pbit.to(_i32)) > 0
        peff = torch.where(
            pothers & pmhas & (pown == cid[:, None]) & (peff >= E), O, peff
        )
    return peff, plway


class _WholeStep:
    """The step's reads and writes of the trace, the L1 and the directory
    on one device: the whole arrays, in place, through the kernels'
    first modes."""

    def __init__(self, cfg, events, st):
        self.cfg, self.events, self.st = cfg, events, st

    def events_at(self, idx):
        """events[b, c, idx[b, c, ...]]: [B, C, (K,) 4]."""
        Bn, C = idx.shape[:2]
        _, rows_c, ib = _iotas(C, Bn, idx.device)
        if idx.dim() == 3:
            ib, rows_c = ib[..., None], rows_c[:, None]
        return self.events[ib, rows_c, idx.long()]

    def scrub(self, lock_holder, kill_now):
        return inject.scrub_dead(self.cfg, self.st.dirm, lock_holder, kill_now)

    def run_states(self, pline, pslot):
        _, _, ib = _iotas(1, pline.shape[0], pline.device)
        pmrows = self.st.dirm[ib[..., None], pslot.long()]  # [B, C, rl+1, DW]
        return _run_states(self.cfg, self.st.l1, pmrows, pline,
                           _iotas(self.cfg.n_cores, 1, pline.device)[0])

    def probe(self, slot, line, cid, step_no, run_patch, consumed):
        return step_kernels.probe_classify(
            self.cfg, self.st.l1, self.st.dirm, slot, line, cid, step_no, *run_patch
        )

    def sharer_reductions(self, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
                          cid, kn):
        cfg = self.cfg
        return reductions.sharer_reductions(
            cfg, shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid,
            kn.link_lat, kn.router_lat,
            group_tables(cfg, shw.device) if cfg.sharer_group > 1 else None,
        )

    def commit(self, tag_rows, shw, vic_shw, lanes, pc_lanes, cid, step_no, delta,
               run_patch):
        st = self.st
        step_kernels.commit_step(
            self.cfg, st.l1, st.dirm, tag_rows, shw, vic_shw, lanes, pc_lanes,
            cid, step_no, st.counters, delta, *run_patch,
        )

    def finish(self, new):
        return new


# the core-sharded [B, C] int32 lanes the step gathers and splits again
_CORE_LANES = ("cycles", "ptr", "sync_flag", "pf_line", "pf_stride", "pf_streak")


class _ShardedStep:
    """The same reads and writes on a tile mesh (`parallel/sharding.py`):
    each core shard reads its own events and L1 rows and launches the
    probe and the commit on them, in their second modes; directory rows
    move only by request (the rl + 1 run rows, each way's validation row
    and, without a local run, the home row), and each winning or joining
    lane's delta row goes back to its owner bank shard. The [B, C] lanes
    are gathered on the mesh's lead device for the lane logic, which
    also holds the replicated fields (`link_free`, the lock and barrier
    tables, ...), and are split back at the end. Every cross-shard
    tensor goes through the mesh's exchange."""

    def __init__(self, cfg, events, st):
        self.cfg, self.events, self.orig = cfg, events, st
        mesh = st.l1.mesh
        self.ex = mesh.exchange
        Cs = cfg.n_cores // mesh.size
        self.cids = [torch.arange(k * Cs, (k + 1) * Cs, dtype=_i32,
                                  device=mesh.shard_device(k)) for k in mesh.local]
        lanes = self.ex.gather("lanes.in", [
            torch.stack([getattr(st, f)[i] for f in _CORE_LANES]
                        + [st.knobs.cpi[i], st.faults.core_dead[i]], -1)
            for i in range(len(self.cids))
        ]).unbind(-1)
        self.st = st._replace(
            **dict(zip(_CORE_LANES, lanes)),
            dram_free=self.ex.gather("dram.in", list(st.dram_free)),
            knobs=st.knobs._replace(cpi=lanes[-2]),
            faults=st.faults._replace(core_dead=lanes[-1]),
        )

    def _split(self, name, x, axis=1):
        return [p.contiguous() for p in self.ex.split(name, x, axis)]

    def events_at(self, idx):
        out = []
        for ev, p in zip(self.events, self.ex.split("events.ids", idx)):
            Bn, Cs = p.shape[:2]
            _, rows_c, ib = _iotas(Cs, Bn, p.device)
            if p.dim() == 3:
                ib, rows_c = ib[..., None], rows_c[:, None]
            out.append(ev[ib, rows_c, p.long()])
        return self.ex.gather("events", out)

    def scrub(self, lock_holder, kill_now):
        wbs = []
        for d, kill, lh in zip(self.orig.dirm, self.ex.bcast("scrub.kill", kill_now),
                               self.ex.bcast("scrub.locks", lock_holder)):
            lh_new, wb = inject.scrub_dead(self.cfg, d, lh, kill)
            wbs.append(wb)
        # every bank shard frees the same lock slots
        return lh_new.to(lock_holder.device), self.ex.sum("scrub.wb", wbs)

    def run_states(self, pline, pslot):
        parts = self.ex.split("run.lines", torch.stack([pline, pslot], -1))
        self.run_rows = self.ex.rows("run.rows", self.orig.dirm,
                                     [p[..., 1] for p in parts])
        out = [
            torch.stack([x.to(_i32) for x in _run_states(
                self.cfg, l1, rows, p[..., 0].contiguous(), cid)], -1)
            for l1, rows, p, cid in zip(self.orig.l1, self.run_rows, parts, self.cids)
        ]
        g = self.ex.gather("run.states", out)
        return g[..., 0], g[..., 1]

    def probe(self, slot, line, cid, step_no, run_patch, consumed):
        cfg = self.cfg
        S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
        FS = W1 * S1
        cols = [slot, line] + ([consumed.to(_i32)] if consumed is not None else [])
        parts = self.ex.split("probe.lanes", torch.stack(cols, -1))
        self.steps = self.ex.bcast("probe.step", step_no)
        self.patches = [()] * len(parts)
        if run_patch:
            hm, wm, cm = run_patch
            pp = self.ex.split("probe.patch", torch.stack(
                [hm.to(_i32), wm.to(_i32), cm.to(_i32)], -1))
            self.patches = [(p[..., 0] != 0, p[..., 1] != 0, p[..., 2].contiguous())
                            for p in pp]
        # each way's directory pointer, from the shard's own L1 rows (the
        # local run's patch leaves the pointer plane alone)
        vidx = []
        for l1, p in zip(self.orig.l1, parts):
            wcols = torch.arange(W1, dtype=_i32, device=l1.device) * S1 + (p[..., 1:2] & (S1 - 1))
            vidx.append(l1.gather(2, (wcols + 3 * FS).long()) // W2)
        vrows = [r.contiguous() for r in self.ex.rows("probe.vrows", self.orig.dirm, vidx)]
        if consumed is None:
            mrows = [r[:, :, 0] for r in self.ex.rows(
                "probe.mrows", self.orig.dirm, [p[..., :1] for p in parts])]
        else:  # the home row is one of the run's rows
            mrows = []
            for rows, p in zip(self.run_rows, parts):
                _, rows_c, ib = _iotas(rows.shape[1], rows.shape[0], rows.device)
                mrows.append(rows[ib, rows_c, p[..., 2].long()])
        self.outs = [
            step_kernels.probe_classify_staged(
                cfg, l1, vr, mr.contiguous(), p[..., 1].contiguous(), c, s, *pt)
            for l1, vr, mr, p, c, s, pt in zip(self.orig.l1, vrows, mrows, parts,
                                                self.cids, self.steps, self.patches)
        ]
        g = self.ex.gather("probe.out", [torch.cat([o[1], o[2], o[5]], -1)
                                         for o in self.outs])
        return None, g[..., :W1], g[..., W1:2 * W1], None, None, g[..., 2 * W1:]

    def sharer_reductions(self, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
                          cid, kn):
        cfg = self.cfg
        lanes = torch.stack([btile, vic_owner, inv_row.to(_i32), vic_valid.to(_i32)], -1)
        parts = self._split("reduce.lanes", lanes)
        lats = self.ex.bcast("reduce.lat", torch.stack([kn.link_lat, kn.router_lat], -1))
        out = []
        for o, p, lat, c in zip(self.outs, parts, lats, self.cids):
            r = reductions.sharer_reductions(
                cfg, o[3], o[4], p[..., 0].contiguous(), p[..., 1], p[..., 2] != 0,
                p[..., 3] != 0, c, lat[:, 0].contiguous(), lat[:, 1].contiguous(),
                group_tables(cfg, p.device) if cfg.sharer_group > 1 else None,
            )
            out.append(torch.stack(r, -1))
        return self.ex.gather("reduce.out", out).unbind(-1)

    def commit(self, tag_rows, shw, vic_shw, lanes, pc_lanes, cid, step_no, delta,
               run_patch):
        rows, slots = [], []
        for l1, o, ln, dl, cnt, c, s, pt in zip(
                self.orig.l1, self.outs, self._split("commit.lanes", lanes),
                self._split("commit.delta", delta, 2), self.orig.counters, self.cids,
                self.steps, self.patches):
            r, us = step_kernels.commit_step_rows(
                self.cfg, l1, o[0], o[3], o[4], ln, o[5], c, s, cnt, dl, *pt)
            rows.append(r)
            slots.append(us)
        self.ex.add_rows("commit.rows", self.orig.dirm, slots, rows)

    def finish(self, new):
        orig, ex = self.orig, self.ex
        mesh = orig.l1.mesh
        parts = ex.split("lanes.out", torch.stack(
            [getattr(new, f) for f in _CORE_LANES] + [new.faults.core_dead], -1))
        fields = [Shards([p[..., j] for p in parts], -1, mesh)
                  for j in range(len(_CORE_LANES) + 1)]
        dram = orig.dram_free if new.dram_free is self.st.dram_free else Shards(
            ex.split("dram.out", new.dram_free), -1, mesh)
        return new._replace(
            **dict(zip(_CORE_LANES, fields)),
            l1=orig.l1, dirm=orig.dirm, counters=orig.counters, dram_free=dram,
            knobs=orig.knobs, faults=new.faults._replace(core_dead=fields[-1]),
        )


def step(cfg: MachineConfig, events, st: MachineState, has_sync: bool = True,
         scrub: bool = True, live=None):
    """Advance every core of every element by one step. `events` is the
    [B, C, T, 4] int32 line-granular trace of a batched state (`state.
    batch_state`), or the [C, T, 4] trace of a solo one, which runs as a
    batch of one. Updates `st.l1`, `st.dirm` and `st.counters` IN PLACE
    (`commit_step`: the L1 plane writes, the directory deltas and the
    counter fold; under faults the dead-core scrub of `dirm`) and returns
    the new state, which holds those same tensors. `scrub=False` skips
    the scrub on a step where the caller knows no core can die in any
    element (`faults.inject.kill_possible`); it is exact only there.

    `live` ([B] int32 0/1 on the device, or None for all 1) is added to
    the step counter: an element whose cores have all ended or died steps
    as a no-op but for that counter, so 0 freezes it whole (the JAX
    fleet's select-masked `run`); its scheduled faults do not fire."""
    if events.dim() == 3:
        bst = batch_state(st)
        return _unbatch(step(cfg, _batched(events), bst, has_sync, scrub, live), bst, st)
    ax = (_ShardedStep if is_sharded(st) else _WholeStep)(cfg, events, st)
    st = ax.st  # what the lane logic reads: on a mesh, the lanes gathered
    C, B = cfg.n_cores, cfg.n_banks
    Bn = events.shape[0]  # elements
    S1 = cfg.l1.sets
    S2, W2 = cfg.llc.sets, cfg.llc.ways
    NS = B * S2  # directory rows
    T = events.shape[2]
    n_tiles = cfg.n_tiles
    dev = events.device
    arange_c, rows_c, ib = _iotas(C, Bn, dev)  # core ids, as long, elements [B, 1]
    kn = st.knobs  # [B] per element; `kb` views them as [B, 1] against the lanes
    kb = kn._replace(**{k: v[:, None] for k, v in kn._asdict().items() if k != "cpi"})
    Q, cpi, l1_lat, llc_lat = kb.quantum, kn.cpi, kb.l1_lat, kb.llc_lat
    acc: dict[str, torch.Tensor] = {}  # counter deltas, folded by commit_step

    def cadd(name, amount):
        a = amount.to(_i32)
        acc[name] = acc[name] + a if name in acc else a

    # ---- phase 0: quantum barrier (on step-entry state)
    rl = cfg.local_run_len
    if rl:
        ioff = torch.arange(rl + 1, dtype=_i32, device=dev)
        pidx = (st.ptr[..., None] + ioff).clamp(max=T - 1)
        pev = ax.events_at(pidx)  # [B, C, rl+1, 4]
        et0 = pev[:, :, 0, 0]
    else:
        et0 = ax.events_at(st.ptr.clamp(max=T - 1))[..., 0]

    # ---- phase -1: fault injection (DESIGN.md §12). Only cores that have
    # not reached END absorb faults. The scrub rewrites the directory in
    # place, before the local runs and the probe read it.
    if cfg.faults_enabled:
        fsf = st.faults
        alive0 = (et0 != EV_END) & (fsf.core_dead == 0)
        # a frozen element's faults do not fire: no schedule row has step -2
        fstep = st.step if live is None else torch.where(live != 0, st.step, -2)
        kill_sched, link_dead_n, link_extra_n = inject.fire_events(cfg, fsf, fstep)
        ecc_corr, ecc_due, l1_due = inject.ecc_step(cfg, fsf, fstep)
        kill_new = kill_sched
        if cfg.fault_due_failstop:  # an L1 DUE is fatal to its core
            kill_new = kill_new | l1_due.to(_i32)
        kill_now = kill_new * alive0.to(_i32)
        cadd("core_failstops", kill_now)
        cadd("ecc_corrected", torch.where(alive0, ecc_corr, 0))
        cadd("ecc_due", torch.where(alive0, ecc_due, 0))
        lock_holder_f = st.lock_holder
        if scrub:
            lock_holder_f, wb_dead = ax.scrub(st.lock_holder, kill_now)
            if cfg.fault_dead_policy == "writeback":
                cadd("l1_writebacks", wb_dead)
        fsf = fsf._replace(
            core_dead=fsf.core_dead | kill_now,
            link_dead=link_dead_n,
            link_extra=link_extra_n,
        )
        st = st._replace(lock_holder=lock_holder_f, faults=fsf)
        deadb = fsf.core_dead != 0  # dead cores leave every mask

    countable0 = (et0 != EV_END) & ~((et0 == EV_BARRIER) & (st.sync_flag != 0))
    if cfg.faults_enabled:  # a dead core neither bumps nor bounds the quantum
        countable0 = countable0 & ~deadb
    # per element: every reduction runs over its own cores
    any_countable = countable0.any(-1)
    any_active = (countable0 & (st.cycles < st.quantum_end[:, None])).any(-1)
    min_nd = torch.where(countable0, st.cycles, INT32_MAX).amin(-1)
    bumped = (min_nd // kn.quantum + 1) * kn.quantum
    quantum_end = torch.where(any_countable & ~any_active, bumped, st.quantum_end)
    qe = quantum_end[:, None]
    step_no = st.step

    # ---- phase 0.5: closed-form local runs (DESIGN.md §3)
    cycles_c, ptr_c = st.cycles, st.ptr
    logB = B.bit_length() - 1
    coarse = cfg.sharer_group > 1
    moesi = cfg.coherence == "moesi"
    if rl:
        pline = pev[..., 2]
        ps = pline & (S1 - 1)
        pslot = (pline & (B - 1)) * S2 + ((pline >> logB) & (S2 - 1))
        peff, plway = ax.run_states(pline, pslot)
        phitcol = plway * S1 + ps
        etr, eargr, eprer = pev[:, :, :rl, 0], pev[:, :, :rl, 1], pev[:, :, :rl, 3]
        peffr = peff[..., :rl]
        is_ins_k = etr == EV_INS
        r_hit_k = (etr == EV_LD) & (peffr != I)
        w_hit_k = (etr == EV_ST) & ((peffr == E) | (peffr == M))
        hit_k = r_hit_k | w_hit_k
        local_k = (is_ins_k | hit_k).to(_i32)
        pref = local_k.cummin(-1).values != 0  # every earlier candidate local
        if cfg.faults_enabled:
            pref = pref & ~deadb[..., None]  # dead cores retire nothing
        cost_k = torch.where(
            is_ins_k, eargr * cpi[..., None], eprer * cpi[..., None] + l1_lat[..., None]
        )
        cost_p = torch.where(pref, cost_k, 0)
        clock_before = cycles_c[..., None] + cost_p.cumsum(-1, dtype=_i32) - cost_p
        retire_k = pref & (clock_before < qe[..., None])
        cycles_c = cycles_c + torch.where(retire_k, cost_k, 0).sum(-1, dtype=_i32)
        ptr_c = ptr_c + retire_k.sum(-1, dtype=_i32)
        cadd("l1_read_hits", (r_hit_k & retire_k).sum(-1, dtype=_i32))
        cadd("l1_write_hits", (w_hit_k & retire_k).sum(-1, dtype=_i32))
        cadd(
            "instructions",
            torch.where(
                retire_k, torch.where(is_ins_k, eargr, eprer + 1), 0
            ).sum(-1, dtype=_i32),
        )
        run_patch = (hit_k & retire_k, w_hit_k & retire_k, phitcol[..., :rl])
    else:
        run_patch = ()

    # ---- phase 0.9 + 1: the arbitration event and its L1 probe
    if rl:
        consumed = (ptr_c - st.ptr).long()
        ev = pev[ib, rows_c, consumed]  # [B, C, 4]
    else:
        ev = ax.events_at(ptr_c.clamp(max=T - 1))
    et, earg, eaddr, epre = ev.unbind(-1)
    line = eaddr.contiguous()
    bank = line & (B - 1)
    slot = bank * S2 + ((line >> logB) & (S2 - 1))
    # on a mesh the shards keep tag_rows, shw and vic_shw (None here)
    tag_rows, lru_rows, weff, shw, vic_shw, pc_lanes = ax.probe(
        slot, line, arange_c, step_no, run_patch, consumed if rl else None
    )
    hit_any = pc_lanes[..., PL_HIT_ANY] != 0
    hit_way = pc_lanes[..., PL_HIT_WAY]
    hit_state = pc_lanes[..., PL_HIT_STATE]

    not_done = et != EV_END
    frozen = (et == EV_BARRIER) & (st.sync_flag != 0)
    active = not_done & ~frozen & (cycles_c < qe)
    if cfg.faults_enabled:
        active = active & ~deadb
    is_ins = active & (et == EV_INS)
    is_st_ev = et == EV_ST
    is_mem = active & ((et == EV_LD) | is_st_ev)
    is_lock = active & (et == EV_LOCK)
    is_unlock = active & (et == EV_UNLOCK)
    is_barrier = active & (et == EV_BARRIER)

    llc_has = pc_lanes[..., PL_LLC_HAS] != 0
    llc_hway = pc_lanes[..., PL_LLC_HWAY]
    owner = pc_lanes[..., PL_OWNER]
    other_sharers = pc_lanes[..., PL_OTHER_SH] != 0
    if moesi:
        # derived Owned: an E/M hit while the home still names this core
        # owner with other sharers recorded reads locally, but its store
        # arbitrates as an upgrade (the stored plane keeps E/M)
        hit_state = torch.where(
            hit_any & llc_has & (owner == arange_c) & other_sharers
            & (hit_state >= E),
            O,
            hit_state,
        )

    read_hit = is_mem & ~is_st_ev & hit_any
    write_hit = is_mem & is_st_ev & hit_any & ((hit_state == E) | (hit_state == M))
    upg = is_mem & is_st_ev & hit_any & ((hit_state == S) | (hit_state == O))
    gets = is_mem & ~is_st_ev & ~hit_any
    getm = is_mem & is_st_ev & ~hit_any

    # ---- phase 2: read-join coalescing + per-(bank,set) arbitration.
    # No joins under Dir-G: same-group joiners' bit updates would collide.
    join_elig = gets & llc_has & (owner == -1) & other_sharers
    if coarse:
        join_elig = torch.zeros_like(join_elig)
    req = (gets & ~join_elig) | getm | upg
    rel = cycles_c - (qe - Q)  # in [0, Q) for active requesters
    key = rel * C + arange_c  # orders by (cycles, core id) within an element
    slot_l = slot.long()
    table = _scatter_min(NS, torch.where(req, slot, NS), key)
    slot_busy = table.gather(1, slot_l) != INT32_MAX
    join = join_elig & ~slot_busy
    demoted = join_elig & slot_busy
    table = torch.minimum(table, _scatter_min(NS, torch.where(demoted, slot, NS), key))
    req = req | demoted
    winner = req & (table.gather(1, slot_l) == key)
    cadd("retries", req & ~winner)

    # ---- phase 3: directory transition on step-start state
    ctile = arange_c % n_tiles
    btile = bank % n_tiles
    req_lat, req_hops = _one_way(cfg, ctile, btile, kb)
    rep_lat, rep_hops = _one_way(cfg, btile, ctile, kb)
    if cfg.faults_enabled:
        # the request/reply legs' detour and degrade extras. The nominal
        # legs go through the contention and router blocks unchanged; the
        # extras join the composed latencies after them.
        fx_req, fh_req, rr_req = inject.leg_fault_penalty(cfg, st.faults, kn, ctile, btile)
        fx_rep, fh_rep, rr_rep = inject.leg_fault_penalty(cfg, st.faults, kn, btile, ctile)
        flt_rt = fx_req + fx_rep  # round-trip fault extra of home transactions
    bid = torch.where(et == EV_BARRIER, eaddr, 0)
    htile = bid % n_tiles

    # ---- NoC contention. This step's home transactions (memory winners
    # and joins, lock/unlock RMWs) and barrier arrivals. Tile model: each
    # pays contention_lat per other transaction at its home tile. Link
    # model: contention_lat times the worst (count - 1) over the links of
    # its XY path. The router model replaces the analytic legs wholesale
    # once the service times are known (below).
    router = cfg.noc.contention and cfg.noc.contention_model == "router"
    home_txn = winner | join
    if has_sync:
        home_txn = home_txn | is_lock | is_unlock
    if cfg.noc.contention and cfg.noc.contention_model != "tile":
        # the XY routes of the request, reply and barrier-arrival legs
        req_p = topology.path_links(cfg, ctile, btile)  # [C, H]
        rep_p = topology.path_links(cfg, btile, ctile)
        legs = [(req_p, home_txn), (rep_p, home_txn)]
        if has_sync:
            arr_p = topology.path_links(cfg, ctile, htile)
            legs.append((arr_p, is_barrier))
    if cfg.noc.contention and not router:
        ccl = kb.contention_lat
        one = torch.ones((), dtype=_i32, device=dev)
        if cfg.noc.contention_model == "link":
            NL = mesh.n_links(cfg)
            lpth, lmask = mesh.concat_legs(legs)
            lcnt = _scatter_drop(
                torch.zeros(Bn, NL, dtype=_i32, device=dev),
                torch.where(lmask & (lpth >= 0), lpth, NL).flatten(1), one, "add",
            )

            def path_worst(pth):
                idx = torch.where(pth >= 0, pth, 0).long()
                cts = lcnt.gather(1, idx.flatten(1)).view(idx.shape)
                return torch.where(pth >= 0, cts - 1, 0).amax(-1)

            extra_home = ccl * torch.maximum(path_worst(req_p), path_worst(rep_p))
            extra_bar = ccl * path_worst(arr_p) if has_sync else None
        else:
            tcnt = _scatter_drop(
                torch.zeros(Bn, n_tiles, dtype=_i32, device=dev),
                torch.where(home_txn, btile, n_tiles), one, "add",
            )
            if has_sync:
                tcnt = _scatter_drop(
                    tcnt, torch.where(is_barrier, htile, n_tiles), one, "add"
                )
            extra_home = ccl * (tcnt.gather(1, btile.long()) - 1)  # valid where home_txn
            extra_bar = ccl * (tcnt.gather(1, htile.long()) - 1)  # valid where is_barrier
        cadd(
            "noc_contention_cycles",
            torch.where(home_txn, extra_home, 0)
            + (torch.where(is_barrier, extra_bar, 0) if has_sync else 0),
        )
    else:
        extra_home = extra_bar = torch.zeros(Bn, C, dtype=_i32, device=dev)

    llc_hit = llc_has & winner
    llc_miss = winner & ~llc_has
    has_owner = llc_hit & (owner >= 0) & (owner != arange_c)
    oclamp = owner.clamp(min=0)
    po_lat, po_hops = _one_way(cfg, btile, oclamp % n_tiles, kb)
    if cfg.faults_enabled:
        # the probe leg keeps its symmetric round trip (2 * po_lat): the
        # forward leg's penalty is charged both ways
        fx_po, fh_po, rr_po = inject.leg_fault_penalty(
            cfg, st.faults, kn, btile, oclamp % n_tiles
        )
        po_lat = po_lat + fx_po
        po_hops = po_hops + fh_po
    gets_w = gets & winner
    write_w = (getm | upg) & winner
    gets_probe = gets_w & llc_hit & has_owner
    gets_shared = gets_w & llc_hit & ~has_owner & other_sharers
    gets_excl_hit = gets_w & llc_hit & ~has_owner & ~other_sharers
    write_probe = write_w & llc_hit & has_owner

    vic_tag = pc_lanes[..., PL_VIC_TAG]
    vic_owner = pc_lanes[..., PL_VIC_OWNER]
    llc_vway = pc_lanes[..., PL_LLC_VWAY]
    vic_valid = llc_miss & (vic_tag != -1)
    inv_row = write_w & llc_hit
    inv_lat, inv_count, inv_hops, back_count, back_hops = ax.sharer_reductions(
        shw, vic_shw, btile, vic_owner, inv_row, vic_valid, arange_c, kn
    )

    # ---- stride prefetcher: a per-core stride detector over the winners
    # and joins (retries re-observe their line and must not train). An
    # LLC miss within prefetch_degree strides ahead of the last trained
    # line on a confirmed stride (streak >= 2) is covered: it pays
    # prefetch_lat instead of dram_lat and skips the controller queue,
    # while dram_accesses still counts it. Training reads step-entry state.
    if cfg.prefetcher == "stride":
        pfl, pfs, pfk = st.pf_line, st.pf_stride, st.pf_streak
        stride = line - pfl
        # floor division, as JAX's // (descending streams divide negatives)
        qd = torch.div(stride, torch.where(pfs == 0, 1, pfs), rounding_mode="floor")
        pf_hit = (
            llc_miss & (pfs != 0) & (pfk >= 2) & (stride - qd * pfs == 0)
            & (qd >= 1) & (qd <= kb.prefetch_degree)
        )
        miss_dram = llc_miss & ~pf_hit
        cadd("prefetch_hits", pf_hit)
        pf_train = winner | join
        pf_streak_n = torch.where(
            pf_train, torch.where((stride == pfs) & (pfs != 0), pfk + 1, 1), pfk
        )
        pf_stride_n = torch.where(pf_train, stride, pfs)
        pf_line_n = torch.where(pf_train, line, pfl)
    else:
        pf_hit = None
        miss_dram = llc_miss
        pf_line_n, pf_stride_n, pf_streak_n = st.pf_line, st.pf_stride, st.pf_streak

    # ---- memory-controller queue: LLC-miss winners queue at their home
    # bank's controller, waiting for max(dram_free[bank], the bank's
    # earliest nominal arrival this step) + rank * service. The lane order
    # is shared with the router block's ranks.
    if cfg.dram_queue or router:
        ord_c = lane_order(key)
    if cfg.dram_queue:
        svc_d = torch.where(kb.dram_service > 0, kb.dram_service, kb.dram_lat)
        a_nom = cycles_c + epre * cpi + l1_lat + req_lat + llc_lat
        dtgt = torch.where(miss_dram, bank, B)  # the misses left to DRAM
        dbase = _scatter_min(B, dtgt, a_nom)
        # non-miss lanes carry the masked segment: their ranks are garbage
        # that the selects below discard
        rd = segmented_rank(dtgt[..., None], n_seg=B, order=ord_c)[..., 0]
        bank_l = bank.long()
        dstart = torch.maximum(
            a_nom,
            torch.maximum(st.dram_free.gather(1, bank_l), dbase.gather(1, bank_l))
            + rd * svc_d,
        )
        extra_dram = torch.where(miss_dram, dstart - a_nom, 0)
        dram_free_n = _scatter_drop(st.dram_free, dtgt, dstart + svc_d, "amax")
        cadd("dram_queue_cycles", extra_dram)
    else:
        extra_dram = torch.zeros(Bn, C, dtype=_i32, device=dev)
        dram_free_n = st.dram_free

    # latency composition (golden order): the service interval between
    # the request's arrival at the home bank and the reply's injection
    probe_any = gets_probe | write_probe
    dram_term = torch.where(miss_dram, kb.dram_lat, 0)
    if pf_hit is not None:  # covered misses pay the prefetch buffer's latency
        dram_term = dram_term + torch.where(pf_hit, kb.prefetch_lat, 0)
    service = torch.where(
        winner,
        llc_lat
        + torch.where(probe_any, 2 * po_lat, 0)
        + torch.where(inv_row, inv_lat, 0)
        + dram_term
        + extra_dram,
        llc_lat,
    )
    link_free_n = st.link_free
    if router:
        # ---- hop-by-hop router: every directed link keeps a next-free
        # clock across steps; a packet waits at link l for
        # max(link_free[l], base[l]) + rank * link_lat (base: the link's
        # earliest nominal arrival this step; rank: packets on l with a
        # smaller key), then pays router_lat at the next router. The
        # cascade over the hops, with the link gathers and the departures'
        # scatter-max into link_free, is router_cascade.
        NL = mesh.n_links(cfg)
        L_lat, R_lat = kb.link_lat, kb.router_lat
        c_hop = L_lat + R_lat
        H = req_p.shape[-1]
        hidx = torch.arange(H, dtype=_i32, device=dev)
        first_lock = is_lock & (st.sync_flag == 0)
        mem_lane = winner | join
        pre_chg = mem_lane | is_unlock | first_lock | is_barrier
        t0 = (
            cycles_c
            + torch.where(pre_chg, epre * cpi, 0)
            + torch.where(mem_lane, l1_lat, 0)
        )
        # nominal (uncontended) arrival at each hop; the reply leg leaves
        # after llc.latency of service by definition
        a_req = t0[..., None] + R_lat[..., None] + hidx * c_hop[..., None]
        a_rep = a_req + (req_hops * c_hop + llc_lat + R_lat)[..., None]
        pth_all, mask_all = mesh.concat_legs(legs)
        a_all = torch.cat([a_req, a_rep] + ([a_req] if has_sync else []), -1)
        ok_all = mask_all & (pth_all >= 0)
        tgt_all = torch.where(ok_all, pth_all, NL)
        # contiguous for the kernel: a batch's rows are cut from [B, NL + 1]
        base = _scatter_min(NL, tgt_all.flatten(1), a_all.flatten(1)).contiguous()
        r_all = segmented_rank(tgt_all, n_seg=NL, order=ord_c)
        if has_sync:
            arr_lat_a, arr_hops = _one_way(cfg, ctile, htile, kb)
        else:
            arr_hops = None
        # a copy: every floor must read the clocks before any departure
        link_free_n = st.link_free.clone()
        t_rep_end, t_arr_end = router_kernels.router_cascade(
            st.link_free, base, pth_all, ok_all, r_all, t0, service,
            req_hops, rep_hops, arr_hops, kn.link_lat, kn.router_lat, link_free_n,
            has_sync=has_sync,
        )
        raw_rt = t_rep_end - t0  # valid on home_txn lanes
        extra_home = raw_rt - (req_lat + service + rep_lat)
        if has_sync:
            raw_arr = t_arr_end - t0  # valid on barrier lanes
            extra_bar = raw_arr - arr_lat_a
        cadd(
            "noc_contention_cycles",
            torch.where(home_txn, extra_home, 0)
            + (torch.where(is_barrier, extra_bar, 0) if has_sync else 0),
        )
        lat = l1_lat + raw_rt  # memory lanes, service included
        lat_join = lat
    else:
        lat = l1_lat + req_lat + service + rep_lat + extra_home
        lat_join = l1_lat + req_lat + llc_lat + rep_lat + extra_home
    if cfg.faults_enabled:
        # after the router block, before the O3 shift (which is not linear)
        lat = lat + flt_rt
        lat_join = lat_join + flt_rt
        req_hops = req_hops + fh_req
        rep_hops = rep_hops + fh_rep
    ov = cfg.core.o3_overlap_256
    if ov:
        lat = lat - ((lat * ov) >> 8)
        lat_join = lat_join - ((lat_join * ov) >> 8)

    grant = torch.where(
        join,
        S,
        torch.where(write_w, M, torch.where(gets_probe | gets_shared, S, E)),
    ).to(_i32)

    # ---- counters for winners + joins
    wj = winner | join
    cadd("l1_read_misses", gets_w | join)
    cadd("l1_write_misses", getm & winner)
    cadd("upgrades", upg & winner)
    cadd("llc_hits", llc_hit | join)
    cadd("llc_misses", llc_miss)
    cadd("dram_accesses", llc_miss)
    cadd("llc_writebacks", llc_miss & vic_valid & (vic_owner >= 0))
    cadd("probes", probe_any)
    cadd("invalidations", torch.where(inv_row, inv_count, 0) + back_count)
    cadd(
        "noc_msgs",
        torch.where(wj, 2, 0)
        + torch.where(probe_any, 2, 0)
        + torch.where(inv_row, 2 * inv_count, 0)
        + torch.where(llc_miss, 2, 0)
        + 2 * back_count,
    )
    cadd(
        "noc_hops",
        torch.where(wj, req_hops + rep_hops, 0)
        + torch.where(probe_any, 2 * po_hops, 0)
        + torch.where(inv_row, inv_hops, 0)
        + back_hops,
    )
    if cfg.faults_enabled:  # one-way legs whose route crossed a dead link
        cadd(
            "noc_reroutes",
            torch.where(wj, rr_req + rr_rep, 0) + torch.where(probe_any, 2 * rr_po, 0),
        )

    # ---- phase 4.A: local updates (array writes deferred to commit_step)
    hit = read_hit | write_hit
    cadd("l1_read_hits", read_hit)
    cadd("l1_write_hits", write_hit)
    mem_ret = hit | wj
    mem_lat = torch.where(hit, l1_lat, torch.where(join, lat_join, lat))
    cycles = cycles_c + torch.where(
        is_ins, earg * cpi, torch.where(mem_ret, epre * cpi + mem_lat, 0)
    )
    ptr = ptr_c + (is_ins | mem_ret).to(_i32)
    cadd(
        "instructions",
        torch.where(is_ins, earg, 0) + torch.where(mem_ret, epre + 1, 0),
    )
    upg_in_place = upg & winner  # an upgrade is always an L1 hit: in place
    fill = (winner & ~upg_in_place) | join
    l1_vway = first_min(torch.where(weff == I, -1, lru_rows))
    cadd("l1_writebacks", fill & (take(weff, l1_vway) == M))
    takes_own = write_w | gets_excl_hit | llc_miss
    NSW = NS * W2
    jway = slot * W2 + llc_hway
    jtab = _scatter_min(NSW, torch.where(join, jway, NSW), key)
    jrep = join & (jtab.gather(1, jway.clamp(max=NSW - 1).long()) == key)
    commit_lanes = torch.stack(
        [
            line, hit_way, l1_vway, hit, write_hit, upg_in_place, winner,
            join, llc_hit, torch.where(write_hit, M, grant), slot, llc_hway,
            llc_vway, jrep, takes_own, gets_probe, gets_shared, oclamp,
        ],
        -1,
    ).to(_i32)  # column order = step_kernels CL_* indices

    # ---- phase 2.7: synchronization events (unlocks -> lock grants ->
    # barrier arrivals -> releases)
    lock_holder = st.lock_holder
    barrier_count = st.barrier_count
    barrier_time = st.barrier_time
    sync_flag = st.sync_flag
    if has_sync:
        L = cfg.lock_slots
        BS = cfg.barrier_slots
        lslot = line & (L - 1)
        # the router's round trip already holds each lane's injection time
        lat_rt = raw_rt if router else req_lat + llc_lat + rep_lat + extra_home
        if cfg.faults_enabled:  # the memory path's core <-> home legs
            lat_rt = lat_rt + flt_rt
        rt_hops = req_hops + rep_hops
        cycles = cycles + torch.where(is_unlock, epre * cpi + lat_rt, 0)
        ptr = ptr + is_unlock.to(_i32)
        cadd("instructions", torch.where(is_unlock, epre + 1, 0))
        cadd("noc_msgs", torch.where(is_unlock, 2, 0))
        cadd("noc_hops", torch.where(is_unlock, rt_hops, 0))
        lslot_l = lslot.long()
        held = lock_holder.gather(1, lslot_l) == arange_c
        lock_holder = _scatter_drop(
            lock_holder, torch.where(is_unlock & held, lslot, L),
            torch.full((), -1, dtype=_i32, device=dev), "set",
        )

        lkey = (cycles_c - (qe - Q)) * C + arange_c
        ltable = _scatter_min(L, torch.where(is_lock, lslot, L), lkey)
        lwin = is_lock & (ltable.gather(1, lslot_l) == lkey)
        holder1 = lock_holder.gather(1, lslot_l)
        lgrant = is_lock & ((holder1 == arange_c) | ((holder1 == -1) & lwin))
        spin = is_lock & ~lgrant
        first = is_lock & (st.sync_flag == 0)  # pre charged on the first try
        cycles = (
            cycles
            + torch.where(first, epre * cpi, 0)
            + torch.where(is_lock, lat_rt, 0)
        )
        cadd("instructions", torch.where(first, epre, 0) + lgrant.to(_i32))
        cadd("lock_acquires", lgrant)
        cadd("lock_spins", spin)
        cadd("noc_msgs", torch.where(is_lock, 2, 0))
        cadd("noc_hops", torch.where(is_lock, rt_hops, 0))
        if cfg.faults_enabled:
            cadd("noc_reroutes", torch.where(is_unlock | is_lock, rr_req + rr_rep, 0))
        lock_holder = _scatter_drop(
            lock_holder, torch.where(lgrant, lslot, L), arange_c, "set"
        )
        sync_flag = torch.where(lgrant, 0, torch.where(spin, 1, sync_flag))
        ptr = ptr + lgrant.to(_i32)

        barr_lat, barr_hops = _one_way(cfg, ctile, htile, kb)
        wake_lat, wake_hops = _one_way(cfg, htile, ctile, kb)
        barr_charge = raw_arr if router else barr_lat + extra_bar
        if cfg.faults_enabled:  # arrival and wake-up legs detour too
            fx_arr, fh_arr, rr_arr = inject.leg_fault_penalty(
                cfg, st.faults, kn, ctile, htile
            )
            fx_wk, fh_wk, rr_wk = inject.leg_fault_penalty(
                cfg, st.faults, kn, htile, ctile
            )
            barr_charge = barr_charge + fx_arr
            barr_hops = barr_hops + fh_arr
            wake_lat = wake_lat + fx_wk
            wake_hops = wake_hops + fh_wk
        cycles = cycles + torch.where(is_barrier, epre * cpi + barr_charge, 0)
        cadd("instructions", torch.where(is_barrier, epre, 0))
        cadd("barrier_waits", is_barrier)
        cadd("noc_msgs", is_barrier)
        cadd("noc_hops", torch.where(is_barrier, barr_hops, 0))
        if cfg.faults_enabled:
            cadd("noc_reroutes", torch.where(is_barrier, rr_arr, 0))
        sync_flag = torch.where(is_barrier, 1, sync_flag)
        bslot = torch.where(is_barrier, bid, BS)
        barrier_count = _scatter_drop(
            barrier_count, bslot, torch.ones((), dtype=_i32, device=dev), "add"
        )
        barrier_time = _scatter_drop(barrier_time, bslot, cycles, "amax")

        bid_l = bid.long()
        wait_m = (et == EV_BARRIER) & (sync_flag == 1)
        if cfg.faults_enabled:
            # fail-stop barrier relief: a dead core never arrives, so the
            # waiters do not wait for it; a dead core already counted in
            # its slot (it arrived, then died) still counts as arrived
            dead_counted = _scatter_drop(
                torch.zeros_like(barrier_count),
                torch.where(wait_m & deadb, bid, BS),
                torch.ones((), dtype=_i32, device=dev), "add",
            )
            missing = deadb.sum(-1, dtype=_i32)[:, None] - dead_counted.gather(1, bid_l)
            released = wait_m & (barrier_count.gather(1, bid_l) + missing >= earg)
        else:
            released = wait_m & (barrier_count.gather(1, bid_l) >= earg)
        cycles = torch.where(released, barrier_time.gather(1, bid_l) + wake_lat, cycles)
        cadd("instructions", released)
        cadd("noc_msgs", released)
        cadd("noc_hops", torch.where(released, wake_hops, 0))
        if cfg.faults_enabled:
            cadd("noc_reroutes", torch.where(released, rr_wk, 0))
        sync_flag = torch.where(released, 0, sync_flag)
        ptr = ptr + released.to(_i32)
        nrel = _scatter_drop(
            torch.zeros_like(barrier_count), torch.where(released, bid, BS),
            torch.ones((), dtype=_i32, device=dev), "add",
        )
        barrier_count = barrier_count - nrel
        drained = barrier_count <= 0
        barrier_count = torch.where(drained, 0, barrier_count)
        barrier_time = torch.where(drained, 0, barrier_time)

    # ---- end-of-step commit: every deferred L1 write, the directory
    # deltas and the counter fold in one kernel, in place
    zero = torch.zeros(Bn, C, dtype=_i32, device=dev)
    delta = torch.stack([acc.get(k, zero) for k in COUNTER_NAMES], 1)  # [B, NC, C]
    ax.commit(tag_rows, shw, vic_shw, commit_lanes, pc_lanes, arange_c, step_no,
              delta, run_patch)

    return ax.finish(st._replace(
        cycles=cycles,
        ptr=ptr,
        link_free=link_free_n,
        dram_free=dram_free_n,
        lock_holder=lock_holder,
        barrier_count=barrier_count,
        barrier_time=barrier_time,
        sync_flag=sync_flag,
        quantum_end=quantum_end,
        step=step_no + (1 if live is None else live),
        pf_line=pf_line_n,
        pf_stride=pf_stride_n,
        pf_streak=pf_streak_n,
        faults=st.faults,  # post-injection (phase -1 rebound st)
    ))


def run_chunk(cfg, n_steps: int, events, st: MachineState, has_sync=True,
              scrub_at=None, live=None):
    """`n_steps` steps, enqueued back to back, of a batched state (or of
    a solo one, as a batch of one). Under faults the dead-core scrub runs
    on the steps whose offsets `scrub_at` holds (the host's
    `kill_possible` steps), or on every step if it is None. `live` is
    `step`'s, for every step of the chunk."""
    solo = events.dim() == 3
    bst0 = batch_state(st) if solo else st
    if solo:
        events = _batched(events)
    bst = bst0
    for i in range(n_steps):
        bst = step(cfg, events, bst, has_sync=has_sync,
                   scrub=scrub_at is None or i in scrub_at, live=live)
    return _unbatch(bst, bst0, st) if solo else bst


def not_done(cfg: MachineConfig, events, st: MachineState):
    """[B, C] bool on the device: the cores of each element neither at
    END nor dead (a fail-stopped core never reaches END: it is done by
    decree)."""
    nd = event_types(events, st.ptr) != EV_END
    if cfg.faults_enabled:
        nd = nd & (_lanes(st.faults.core_dead) == 0)
    return nd


def _lanes(x, name="lanes.host"):
    """A [B, C] field whole on the lead device: gathered from its shards
    on a mesh, as it is otherwise."""
    return x.mesh.exchange.gather(name, list(x)) if isinstance(x, Shards) else x


def event_types(events, ptr):
    """[B, C] int32: the event type under each core's trace pointer
    (END padding included), read by each shard from its own events on a
    mesh."""
    T = events.shape[2]
    if isinstance(events, Shards):
        out = []
        for ev, p in zip(events, ptr):
            _, rows_c, ib = _iotas(p.shape[1], p.shape[0], p.device)
            out.append(ev[ib, rows_c, p.clamp(max=T - 1).long(), 0])
        return events.mesh.exchange.gather("events.types", out)
    _, rows_c, ib = _iotas(ptr.shape[1], ptr.shape[0], ptr.device)
    return events[ib, rows_c, ptr.clamp(max=T - 1).long(), 0]


def drain_rebase(cfg: MachineConfig, events, st: MachineState, nd=None):
    """The end of a chunk on the device, per element: the rebase by whole
    quanta of the element's own quantum (the JAX package's
    `_drain_and_rebase`) and zeroed step counters. Returns (the new
    state, the [B, NC, C] counters it drained, the [B] rebase deltas, the
    [B] bool "some core not done"), none of them read by the host yet,
    so a caller makes one transfer for all three. Done and dead cores do
    not bound the delta, and an element with no core left keeps 0.

    `nd` ([B, C] bool) replaces the not-done mask (the stream loop's:
    a core at its window's END padding whose stream goes on still bounds
    the delta)."""
    if nd is None:
        nd = not_done(cfg, events, st)
    if is_sharded(st):  # the clocks and counters gathered, then split again
        ex = st.l1.mesh.exchange
        whole = st._replace(cycles=_lanes(st.cycles, "drain.lanes"),
                            counters=ex.gather("drain.counters", list(st.counters), 2),
                            dram_free=_lanes(st.dram_free, "drain.lanes"))
        new, cnt, delta, live = _rebase(cfg, whole, nd)
        return new._replace(
            cycles=Shards(ex.split("drain.lanes", new.cycles), -1, st.l1.mesh),
            counters=_zeros_like(st.counters),
            dram_free=Shards(ex.split("drain.lanes", new.dram_free), -1, st.l1.mesh),
        ), cnt, delta, live
    return _rebase(cfg, st, nd)


def _rebase(cfg: MachineConfig, st: MachineState, nd):
    live = nd.any(-1)
    Q = st.knobs.quantum
    m = torch.where(nd, st.cycles, INT32_MAX).amin(-1)
    # the clamp never binds where the JAX package's delta is unclamped:
    # a core that bounds the delta keeps a clock >= 0 after it, and one
    # that leaves the mask (done or dead) never comes back into it
    delta = torch.where(live, (m // Q) * Q, 0).clamp(min=0)
    d = delta[:, None]
    router = cfg.noc.contention and cfg.noc.contention_model == "router"
    new = st._replace(
        cycles=st.cycles - d,
        quantum_end=st.quantum_end - delta,
        barrier_time=torch.where(st.barrier_count > 0, st.barrier_time - d, st.barrier_time),
        # link and controller clocks are epoch-relative too, shifted only
        # when their model is on (the fields stay zero otherwise); the
        # clamp floor lies below every wait comparison, so it is exact and
        # keeps long-idle clocks from wrapping
        link_free=(st.link_free - d).clamp(min=-(1 << 30)) if router else st.link_free,
        dram_free=(st.dram_free - d).clamp(min=-(1 << 30)) if cfg.dram_queue else st.dram_free,
        counters=torch.zeros_like(st.counters),
    )
    return new, st.counters, delta, live


# ---- windowed (streaming) ingest: the JAX package's `stream_loop`

STREAM_REBASE = 64  # steps of a window between two rebases, as in JAX


class WindowOut(NamedTuple):
    """What one window's device loop (`stream_loop`) leaves: the state
    (its `ptr` the window-relative events consumed, its counters zero),
    the counters it drained as int64 [NC, C], the summed rebase deltas,
    the steps executed, the host's copy of `ptr` and the chunks run."""

    state: MachineState
    counters: np.ndarray
    base: int
    steps: int
    ptr: np.ndarray
    chunks: int


def window_chunk(cfg: MachineConfig, events, st: MachineState, n_steps: int,
                 rebase: bool, exhausted, has_sync: bool = True):
    """`n_steps` steps of a solo state on one window ([C, W + 1, 4]
    events), then the drain and, when `rebase`, the rebase over the
    stream's not-done mask (`exhausted`, [C] bool on the device: a core
    bounds the delta unless it sits on END with no events beyond its
    window), with ONE host transfer. Returns (the new state, the [NC, C]
    int32 counters drained, the [C] window-relative pointers, the delta)
    as host numpy but for the state. On a mesh the events and the mask
    are laid out by core shard, and the counters (without a rebase) and
    the pointers are gathered on the lead device for the one transfer."""
    st = run_chunk(cfg, n_steps, events, st, has_sync)
    exch = st.l1.mesh.exchange if is_sharded(st) else None
    if rebase:
        bev, bst = _batched(events), batch_state(st)
        nd = not_done(cfg, bev, bst) | ~_lanes(_batched(exhausted), "stream.exhausted")
        new, cnt, delta, _ = drain_rebase(cfg, bev, bst, nd=nd)
        new = solo_state(new)
    else:
        new = st._replace(counters=_zeros_like(st.counters))
        cnt = st.counters if exch is None else exch.gather("drain.counters", list(st.counters))
        delta = torch.zeros(1, dtype=_i32, device=cnt.device)
    ptr = st.ptr if exch is None else exch.gather("stream.ptr", list(st.ptr), 0)
    host = torch.cat([cnt.flatten(), ptr, delta]).cpu().numpy()
    NC, C = len(COUNTER_NAMES), cfg.n_cores
    return new, host[: NC * C].reshape(NC, C), host[NC * C: -1], int(host[-1])


def stream_loop(cfg: MachineConfig, events, st: MachineState, exhausted,
                filled, max_steps: int, has_sync: bool = True) -> WindowOut:
    """The device loop of one window of a stream (the JAX package's
    `stream_loop`): `events` [C, W + 1, 4] on the device (or its core
    shards on a mesh) holds each core's next events END-padded,
    `exhausted` ([C] bool, host) marks the cores with none beyond the
    window and `filled` ([C], host) counts the real events buffered.
    `st.ptr` must be 0.

    JAX tests its exit on the device before every step: it stops once a
    core that is not exhausted holds fewer than `need = local_run_len +
    1` unconsumed events (the most one step eats), once every core sits
    on END, or at `max_steps`. The port makes the same cut from the host
    with one transfer a chunk: a chunk of n steps is safe while every
    non-exhausted core holds at least n * need events (so JAX's exit
    cannot fire inside it) and while some core holds more than
    (n - 1) * need (so not every core can reach END before its last
    step), and it ends on each 64-step mark of the window, where JAX
    drains and rebases. The host reads `ptr` back after each chunk and
    sizes the next; the window ends at the first chunk boundary where
    no step is safe, which is exactly the step where JAX's condition
    first fails. Near a window's end the chunks shrink, down to single
    steps."""
    need = cfg.local_run_len + 1
    C = cfg.n_cores
    ex = np.asarray(exhausted, bool)
    filled = np.asarray(filled, np.int64)
    ex_t = torch.from_numpy(ex)  # one upload a window, laid out as the events
    if isinstance(events, Shards):
        from ..parallel.sharding import shard_core_axis

        ex_dev = shard_core_axis(events.mesh, ex_t)
    else:
        ex_dev = ex_t.to(events.device)
    acc = np.zeros((len(COUNTER_NAMES), C), np.int64)
    ptr = np.zeros(C, np.int64)
    base = k = chunks = 0
    while True:
        left = filled - ptr
        n = min(STREAM_REBASE - k % STREAM_REBASE, max_steps - k,
                int((left[~ex] // need).min(initial=max_steps)),
                int(-(-np.maximum(left, 0).max(initial=0) // need)))
        if n <= 0:
            return WindowOut(st, acc, base, k, ptr, chunks)
        k += n
        st, cnt, p, delta = window_chunk(
            cfg, events, st, n, k % STREAM_REBASE == 0, ex_dev, has_sync)
        acc += cnt
        ptr = p.astype(np.int64)
        base += delta
        chunks += 1


def kernels_of(cfg: MachineConfig) -> tuple[str, ...]:
    """The kernels a step of `cfg` launches on a card: the three step
    kernels, and `router_cascade` under the router contention model."""
    from ..kernels.build import KERNELS

    router = cfg.noc.contention and cfg.noc.contention_model == "router"
    return KERNELS if router else tuple(k for k in KERNELS if k != "router_cascade")


# ---- overlapped dispatch (Engine.overlap, FleetEngine.overlap)


class Prefetch(NamedTuple):
    """A speculated chunk: the committed state it was made from (its
    identity is what validates it), the device results of the chunk
    (nothing of them read by the host yet), the chunk size and any other
    inputs that must match (`key`), and, on a card, the event recorded
    after its work on the side stream."""

    source: MachineState
    out: tuple
    chunk_steps: int
    key: object
    done: object


def prefetch(src: MachineState, chunk_steps: int, key, work, side=None,
             keep=()) -> Prefetch:
    """`work` applied to a device copy of `src`, never to `src` itself
    (the step writes in place). On a card the copy and the work run on
    the caller's `side` stream, which first waits for everything already
    queued, and `src` and the other inputs `keep` are marked in use
    there, so that their memory outlives the speculation whoever frees
    them."""
    dev = src.cycles.device
    if dev.type != "cuda":
        return Prefetch(src, work(map_state(torch.clone, src)), chunk_steps, key, None)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out = work(map_state(torch.clone, src))
        done = torch.cuda.Event()
        done.record(side)
    for x in (*leaves(src), *keep):
        x.record_stream(side)
    return Prefetch(src, out, chunk_steps, key, done)


def _out_tensors(out) -> list:
    return [y for x in out for y in (leaves(x) if isinstance(x, MachineState) else (x,))]


def adopt(p: Prefetch) -> tuple:
    """A speculated chunk's results, usable on the current stream: it
    waits for the side stream's work, and the results' memory is marked
    in use here."""
    if p.done is not None:
        main = torch.cuda.current_stream(p.source.cycles.device)
        main.wait_event(p.done)
        for x in _out_tensors(p.out):
            x.record_stream(main)
    return p.out


def drop(p: Prefetch | None) -> None:
    """Forget a speculated chunk; work queued after this on the current
    stream (say, surgery that writes the state's rows in place) waits
    until the speculation has read its source."""
    if p is not None and p.done is not None:
        torch.cuda.current_stream(p.source.cycles.device).wait_event(p.done)


class Engine:
    """Host runner with the JAX `Engine`'s interface and semantics for a
    single device: `run`, `run_chunked`, `run_steps`, `cycles`,
    `counters`, `steps_run`, `state`, `verify_invariants`, `done`, the
    telemetry sink `obs` (an `obs.Recorder` or None) with its `obs_label`,
    and `save_checkpoint`/`load_checkpoint` (`sim/checkpoint.py`: the JAX
    package's file format, so a snapshot of either engine resumes in the
    other). `overlap` (default False) speculates each next chunk as the
    JAX engine's does (`_pending`, `discard_prefetch`; module
    docstring). `mesh` (a `parallel.sharding.TileMesh`) lays the machine
    over a tile mesh, as the JAX `Engine(..., mesh=)` does: the state and
    the events are sharded (`parallel.sharding.state_pspecs`), every step
    runs on the shards (`_ShardedStep`) and the results are the
    unsharded run's, bit for bit; host reads gather what they read."""

    def __init__(
        self, cfg: MachineConfig, trace: Trace, chunk_steps: int = 256,
        device=None, mesh=None,
    ):
        check_port_supported(cfg)
        # on a tile mesh the lead device holds the replicated fields
        self.device = resolve_device(device) if mesh is None else mesh.lead
        self.mesh = mesh
        if trace.n_cores != cfg.n_cores:
            raise ValueError(
                f"trace has {trace.n_cores} cores but config has {cfg.n_cores}"
            )
        self.cfg = cfg
        self.trace = trace
        validate_sync(trace, cfg.barrier_slots)
        t = trace.events[:, :, 0]
        self.has_sync = bool(
            ((t == EV_LOCK) | (t == EV_UNLOCK) | (t == EV_BARRIER)).any()
        )
        # the per-chunk counter increments must stay below 2^_ACC_BITS: the
        # largest per-step increment is the instructions counter, at most
        # (local_run_len + 1) events of max(arg, pre + 1) instructions each
        ev = trace.events
        per_ev = max(
            1, int(ev[:, :, 1].max(initial=0)), int(ev[:, :, 3].max(initial=0)) + 1
        )
        per_step = (cfg.local_run_len + 1) * per_ev
        if chunk_steps * per_step >= 1 << _ACC_BITS:
            raise ValueError(
                f"chunk_steps={chunk_steps} x max per-step instruction "
                f"increment {per_step} overflows the 2^{_ACC_BITS} "
                "per-chunk counter accumulator; lower chunk_steps or split "
                "large INS batches"
            )
        self.events = torch.from_numpy(
            np.ascontiguousarray(trace.line_events(cfg.line_bits), np.int32)
        ).to(self.device)
        self.state = init_state(cfg, self.device)
        if mesh is not None:
            from ..parallel.sharding import shard_events, shard_state

            self.events = shard_events(mesh, self.events)
            self.state = shard_state(mesh, self.state)
        for d in _devices(self.events):  # built and uploaded here, before any step
            if cfg.sharer_group > 1:
                group_tables(cfg, d)
        if cfg.faults_enabled:
            inject.detour_table(cfg, self.state.faults.link_dead.device)
        self.chunk_steps = chunk_steps
        self.cycle_base = 0
        self.host_counters = zero_counters(cfg.n_cores)
        self.steps_run = 0
        self._stepped = None  # the state the last chunk left (see scrub_offsets)
        # telemetry sink (obs.Recorder): None records nothing
        self.obs = None
        self.obs_label = "engine"
        # attestation chain (attest.SoloAttest): None hashes nothing; set,
        # it observes every committed chunk of run_steps (DESIGN.md §24)
        self.attest = None
        # prefix-fork provenance (checkpoint format 6 on): the steps of
        # shared prefix this run was forked from and the warm-cache key of
        # that prefix (0 and None: the run simulated from step 0 itself)
        self.prefix_steps = 0
        self.prefix_cache_key = None
        self._drained = None  # a state whose device counters are zero
        # overlapped dispatch: after a committed chunk, the next one runs
        # on a copy of the state (a `Prefetch`), adopted by the next
        # `_chunk` only if `self.state` is still its source
        self.overlap = False
        self._pending = None
        self._side = None  # the speculation's CUDA stream, made at its first use

    def _not_done(self, st: MachineState):
        """[C] bool on the device: cores neither at END nor dead."""
        return not_done(self.cfg, _batched(self.events), batch_state(st))[0]

    def scrub_offsets(self) -> set[int] | None:
        """Offsets in the next chunk of the steps on which a core can die
        (None without faults). The host counts steps itself from the
        state's step number, read (with the schedule, seed and
        thresholds) only when the state is not the one the last chunk
        left, e.g. a state carried in from elsewhere."""
        if not self.cfg.faults_enabled:
            return None
        if self.state is not self._stepped:
            fs = self.state.faults
            self._host_step = int(self.state.step)
            self._fs_host = {k: getattr(fs, k).cpu().numpy() for k in
                             ("seed", "ev_step", "ev_kind", "flip_l1", "due_rate")}
        steps = np.arange(self._host_step, self._host_step + self.chunk_steps)
        return set(np.flatnonzero(inject.kill_possible(self.cfg, self._fs_host, steps)).tolist())

    def _chunk(self) -> bool:
        """One chunk, then the drain and the rebase by whole quanta (the JAX
        package's `_drain_and_rebase`), with ONE host transfer for the
        counters, the rebase delta and the done flag. Returns done. A
        speculated chunk made from this very state is adopted instead of
        dispatching one.

        The recorder `obs`, when set, gets the host's seconds in the JAX
        package's three phase names, cut where the port's chunk allows:
        "dispatch" is the Python enqueue of the chunk's launches (the
        device runs behind it), "drain" runs from there through the
        device-side rebase's enqueue to the end of the one `.cpu()`, so it
        holds the device's tail, and "rebase" is the host's folding of the
        transferred counters, delta and flag."""
        t0 = time.perf_counter()
        cut = []
        pend, self._pending = self._pending, None
        if pend is not None and pend.source is self.state \
                and pend.chunk_steps == self.chunk_steps:
            new, host = adopt(pend)
        else:
            drop(pend)
            new, host = self._enqueue_chunk(self.state, self.scrub_offsets(), cut)
        t1 = cut[0] if cut else time.perf_counter()
        self.state = new
        host = host.cpu().numpy()
        t2 = time.perf_counter()
        cnt = host[:-2].reshape(len(COUNTER_NAMES), -1)
        for i, k in enumerate(COUNTER_NAMES):
            self.host_counters[k] += cnt[i].astype(np.int64)
        self.cycle_base += int(host[-2])
        self.steps_run += self.chunk_steps
        self._drained = self.state
        if self.cfg.faults_enabled:
            self._host_step += self.chunk_steps
            self._stepped = self.state
        if self.obs is not None:
            t3 = time.perf_counter()
            self.obs.chunk_committed(
                self.obs_label, self.chunk_steps, t3 - t0, self.host_counters,
                phases={"dispatch": t1 - t0, "drain": t2 - t1, "rebase": t3 - t2},
            )
        return bool(host[-1])

    def _enqueue_chunk(self, st: MachineState, scrub_at, cut=None):
        """A chunk of `st` and its drain and rebase, enqueued: (the new
        state, one int32 device tensor of the drained counters, the delta
        and the done flag), nothing read by the host. `cut` gets the time
        the chunk's own launches were enqueued."""
        st = run_chunk(
            self.cfg, self.chunk_steps, self.events, st, self.has_sync,
            scrub_at=scrub_at,
        )
        if cut is not None:
            cut.append(time.perf_counter())
        new, cnt, delta, live = drain_rebase(self.cfg, _batched(self.events),
                                             batch_state(st))
        return solo_state(new), torch.cat([cnt.flatten(), delta, (~live).to(_i32)])

    def _prefetch_chunk(self) -> None:
        """Speculate the next chunk from the committed state (the JAX
        engine's `_prefetch_chunk`) on a copy of it, with the next chunk's
        scrub steps (the host's step number is already past this one)."""
        scrub_at = self.scrub_offsets()
        if self._side is None and self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
        self._pending = prefetch(
            self.state, self.chunk_steps, None,
            lambda st: self._enqueue_chunk(st, scrub_at), self._side, keep=(self.events,),
        )

    def discard_prefetch(self) -> None:
        """Drop any speculated chunk (state surgery makes it moot; the
        identity check would reject it anyway: this frees it)."""
        drop(self._pending)
        self._pending = None

    def run(self, max_steps: int = 10_000_000, debug_invariants: bool = False) -> None:
        """Run to completion; `max_steps` is a deadlock guard rounded up to
        whole chunks. `debug_invariants` checks the DESIGN.md §5 machine
        invariants after every chunk."""
        if not self.run_steps(max_steps, debug_invariants):
            raise RuntimeError("engine: max_steps exceeded (deadlock?)")

    def run_chunked(
        self, max_steps: int = 10_000_000, debug_invariants: bool = False
    ) -> None:
        """The JAX package's host-loop name for `run` (there `run` is one
        fused device loop; here both are this host loop). `max_steps`
        counts from step 0, as in the JAX package."""
        self.run(max_steps - self.steps_run, debug_invariants)

    def run_steps(self, n_steps: int, debug_invariants: bool = False) -> bool:
        """Advance `n_steps` (rounded up to whole chunks) without the
        completion check: run_steps(A) -> save_checkpoint -> (later)
        load_checkpoint -> run() is bit-exact with an uninterrupted run.
        Returns done."""
        target = self.steps_run + n_steps
        done = self.done()
        while self.steps_run < target and not done:
            done = self._chunk()
            if self.overlap and not done:
                self._prefetch_chunk()
            if self.attest is not None:
                # after the drain and the rebase: the committed values
                self.attest.observe(self)
            if debug_invariants:
                self.verify_invariants()
        return done

    def done_mask(self) -> np.ndarray:
        """[C] bool: cores whose trace pointer sits on END, and fail-stopped
        cores (they never reach END: completion means everyone else
        finished)."""
        return ~self._not_done(self.state).cpu().numpy()

    def done(self) -> bool:
        return bool(self.done_mask().all())

    def live_mask(self) -> np.ndarray:
        """[C] bool: cores that bound the quantum window: not at END, not
        frozen at a barrier (a frozen core's clock legally lags
        `quantum_end` until release) and not fail-stopped. The
        supervisor's clock-window guard reads it
        (validate.check_chunk_invariants)."""
        bst = batch_state(self.state)
        et = event_types(_batched(self.events), bst.ptr)[0].cpu().numpy()
        frozen = (et == EV_BARRIER) & (self.state.sync_flag.cpu().numpy() != 0)
        live = (et != EV_END) & ~frozen
        if self.cfg.faults_enabled:
            live &= self.state.faults.core_dead.cpu().numpy() == 0
        return live

    def verify_invariants(self) -> None:
        """Check the DESIGN.md §5 machine invariants on the current state
        (host side; raises AssertionError naming the violation). The state
        is copied to the host once: every view the checks take of it
        (directory, sharers, and under sharer_group > 1 both epoch planes)
        reads that copy."""
        from .validate import check_invariants

        host = self.state._replace(
            **{f: getattr(self.state, f).cpu() for f in self.state._fields
               if f not in ("knobs", "faults")}
        )
        check_invariants(self.cfg, host, done_mask=self.done_mask())

    def save_checkpoint(self, path: str) -> None:
        from .checkpoint import save_checkpoint

        save_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> None:
        from .checkpoint import load_checkpoint

        self.discard_prefetch()
        load_checkpoint(path, self)

    def _drain(self) -> None:
        """Fold the device counters into the host's int64 totals. Free
        after a chunk (its drain zeroed them on the card): no transfer
        then, and the state stays the object a speculation was made from."""
        if self.state is self._drained:
            return
        cnt = self.state.counters.cpu().numpy()
        for i, k in enumerate(COUNTER_NAMES):
            self.host_counters[k] += cnt[i].astype(np.int64)
        self.state = self.state._replace(counters=_zeros_like(self.state.counters))

    @property
    def cycles(self) -> np.ndarray:
        return self.state.cycles.cpu().numpy().astype(np.int64) + self.cycle_base

    @property
    def counters(self) -> dict[str, np.ndarray]:
        self._drain()
        return self.host_counters
