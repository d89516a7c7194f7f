"""The two fused step kernels: `probe_classify` (phase 1) and
`commit_step` (phase 4.A plus the counter fold).

They replace the JAX package's Pallas kernels of the same names
(`kernels/step_kernels.py`) and compute the same functions bit for bit,
with the packed lane columns of the JAX package (PL_* out of the probe,
CL_* into the commit). Their contracts differ where Hopper can do what
Mosaic could not:

- `probe_classify` reads the directory `dirm` itself: each way's three
  validation words at `dirm[ptr // W2]` and the home row `dirm[slot]`, so
  the caller stages no rows. It appends five lanes after PL_LLC_VWAY: the
  home row's tag, LRU and epoch at the hit way and the LRU and epoch at
  the victim way, which is all `commit_step` reads of the home row.
- `commit_step` updates `l1`, `dirm` and `counters` IN PLACE and returns
  nothing: each core's ordered L1 plane writes, the winners' and
  joiners' directory deltas added word by word (the JAX package's
  `dirm.at[upd_slot].add(delta_row, mode="drop")`; other lanes add
  nothing) and `counters += delta`.

Each wrapper runs the CUDA kernel (`csrc/probe_classify.cu`,
`csrc/commit_step.cu`) on CUDA tensors and the plain torch version below
on CPU tensors. Under the coarse sharer vector (`cfg.sharer_group` =
G > 1) a core's sharer bit is its group's, g = cid >> log2(G): the probe
then also reads the L1 epoch plane and keeps a group-bit S copy only
while its fill-time epoch equals the directory entry's (the JAX
package's epoch guard), and a line counts as shared whenever any group
bit is set; the commit records group bits. Under MOESI
(`cfg.coherence`, the Pallas kernel's static `moesi`) the commit keeps
the probed owner recorded on a GETS probe, and the row's sharer words
become the old sharers OR the requester OR the owner (derived Owned);
MOESI needs `sharer_group` == 1. W1, W2 and the local run length are at
most 32 (one warp's lanes).

Both kernels take a batch of B simulations of one geometry in one launch
(the fleet's): every per-element tensor has a leading element axis, the
step number is [B], the core ids `cid` [C] are shared, and each element
probes and commits only its own L1 rows and directory. The solo shapes
are a batch of one (`layouts.unsqueeze_all`).
"""

from __future__ import annotations

import torch

from ..config.machine import MachineConfig
from ..sim.state import I, M, S, dirm_width, llc_meta_width
from . import build
from .layouts import (
    check_tensor,
    first_min,
    first_true,
    popcount,
    squeeze_all,
    take,
    unsqueeze_all,
)

# probe_classify packed-lane indices (column k of the [C, PROBE_LANES]
# output): the JAX package's eleven, then the home-row words commit_step
# needs
(
    PL_HIT_ANY,
    PL_HIT_WAY,
    PL_HIT_STATE,
    PL_LLC_HAS,
    PL_LLC_HWAY,
    PL_OWNER,
    PL_SELF_BIT,
    PL_OTHER_SH,
    PL_VIC_TAG,
    PL_VIC_OWNER,
    PL_LLC_VWAY,
    PL_HOME_TAG,
    PL_HOME_LRU,
    PL_HOME_EPOCH,
    PL_VIC_LRU,
    PL_VIC_EPOCH,
) = range(16)
PROBE_LANES = 16

# commit_step packed-lane indices (column k of the [C, COMMIT_LANES] input)
(
    CL_LINE,
    CL_HIT_WAY,
    CL_L1_VWAY,
    CL_HIT,
    CL_WRITE_HIT,
    CL_UPG_IN_PLACE,
    CL_WINNER,
    CL_JOIN,
    CL_LLC_HIT,
    CL_ST_VAL,
    CL_SLOT,
    CL_LLC_HWAY,
    CL_LLC_VWAY,
    CL_JREP,
    CL_TAKES_OWN,
    CL_GETS_PROBE,
    CL_GETS_SHARED,
    CL_OCLAMP,
) = range(18)
COMMIT_LANES = 18

WARP = 32  # the kernels give a core's ways, LLC ways and run slots one lane each

_i32 = torch.int32


def _take_way(rows, way):
    """rows[b, c, way[b, c], :] of [B, C, W, N] rows: [B, C, N]."""
    idx = way.long()[..., None, None].expand(*way.shape, 1, rows.shape[-1])
    return rows.gather(2, idx)[:, :, 0]


def probe_classify_plain(
    cfg: MachineConfig, l1, dirm, slot, line, cid, step_no,
    hm=None, wm=None, cm=None,
):
    """Plain torch version of phase 1: returns (tag_rows, lru_rows, weff)
    [B, C, W1], (shw, vic_shw) [B, C, NW] and the lanes
    [B, C, PROBE_LANES] (without the leading B for solo inputs). Every
    pointer in the accessed set lies in [0, NS*W2)."""
    if l1.dim() == 2:
        return squeeze_all(probe_classify_plain(
            cfg, *unsqueeze_all(l1, dirm, slot, line), cid,
            *unsqueeze_all(step_no, hm, wm, cm),
        ))
    Bn, C = l1.shape[:2]
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    FS = W1 * S1
    coarse = cfg.sharer_group > 1
    g = cid >> (cfg.sharer_group.bit_length() - 1)  # the core's sharer bit
    dev = l1.device
    l1s = line & (S1 - 1)
    w1cols = torch.arange(W1, dtype=_i32, device=dev) * S1 + l1s[..., None]
    n_planes = 5 if coarse else 4  # the epoch plane only under Dir-G
    planes = l1.gather(
        2, torch.cat([w1cols + p * FS for p in range(n_planes)], -1).long()
    ).split(W1, -1)
    tag_w, st_w, lru_w, ptr_w = planes[:4]
    if hm is not None:
        # the local run's deferred L1 writes, patched in: E->M at wm
        # columns, LRU stamps at hm columns
        colm = cm[..., None] == w1cols[:, :, None, :]  # [B, C, rl, W1]
        st_w = torch.where(((wm[..., None] != 0) & colm).any(2), M, st_w)
        lru_w = torch.where(
            ((hm[..., None] != 0) & colm).any(2), step_no[:, None, None], lru_w
        )

    # pointer validation of every way against its directory entry, the
    # words (tag, owner, own sharer word) of row ptr // W2 at way ptr % W2;
    # under Dir-G the group bit also needs the entry's epoch unchanged
    pway = ptr_w % W2
    prow = (ptr_w // W2).long() * DW
    flat = dirm.view(Bn, -1)

    def word(idx):  # flat[b, idx[b, ...]]
        return flat.gather(1, idx.reshape(Bn, -1)).view(idx.shape)

    vtag = word(prow + 2 * pway)
    vown = word(prow + 2 * pway + 1)
    vsh = word(prow + MW + pway * NW + (g[:, None] >> 5))
    vbit = ((vsh >> (g[:, None] & 31)) & 1) != 0
    if coarse:
        vbit = vbit & (word(prow + 3 * W2 + pway) == planes[4])
    weff = torch.where(
        (st_w == I) | (vtag != tag_w),
        I,
        torch.where(vown == cid[:, None], st_w, torch.where(vbit, S, I)),
    ).to(_i32)

    hit_any, hit_way = first_true((tag_w == line[..., None]) & (weff != I))
    hit_state = take(weff, hit_way)

    # LLC home-row parse
    ib = torch.arange(Bn, device=dev)[:, None]
    mrows = dirm[ib, slot.long()]  # [B, C, DW]
    ltag = mrows[..., 0 : 2 * W2 : 2]
    lown = mrows[..., 1 : 2 * W2 : 2]
    llru = mrows[..., 2 * W2 : 3 * W2]
    leph = mrows[..., 3 * W2 : 4 * W2]
    llc_has, llc_hway = first_true(ltag == line[..., None])
    sh_rows = mrows[..., MW:].view(Bn, C, W2, NW)
    shw = _take_way(sh_rows, llc_hway)
    gb = g.expand(Bn, C)
    self_bit = (take(shw, gb >> 5) >> (gb & 31)) & 1
    total = popcount(shw).sum(-1, dtype=_i32)
    # a group bit may stand for other cores: under Dir-G any set bit shares
    other_sh = total > 0 if coarse else (total - self_bit) > 0

    # victim: first minimum of LRU over valid ways
    llc_vway = first_min(torch.where(ltag != -1, llru, -1))
    vic_shw = _take_way(sh_rows, llc_vway)
    lanes = torch.stack(
        [
            hit_any.to(_i32), hit_way, hit_state, llc_has.to(_i32), llc_hway,
            take(lown, llc_hway), self_bit, other_sh.to(_i32),
            take(ltag, llc_vway), take(lown, llc_vway), llc_vway,
            take(ltag, llc_hway), take(llru, llc_hway), take(leph, llc_hway),
            take(llru, llc_vway), take(leph, llc_vway),
        ],
        -1,
    )
    return tag_w, lru_w, weff, shw, vic_shw, lanes


def _write(blk, mask, col, val):
    """blk[b, c, col[b, c]] = val[b, c] where mask[b, c]: one ordered plane
    write (each row gets at most one column, so the scatter is
    deterministic). `val` broadcasts against `mask`."""
    col = torch.where(mask, col, 0).long()[..., None]
    cur = blk.gather(2, col)
    val = torch.as_tensor(val, dtype=_i32, device=blk.device).expand(mask.shape)
    blk.scatter_(2, col, torch.where(mask[..., None], val[..., None], cur))


def commit_step_plain(
    cfg: MachineConfig, l1, dirm, tag_rows, shw, vic_shw, lanes, pc_lanes,
    cid, step_no, counters, delta, hm=None, wm=None, cm=None,
) -> None:
    """Plain torch version of phase 4.A + the counter fold, in place on
    `l1`, `dirm` and `counters`. `pc_lanes`, `shw` and `vic_shw` are the
    probe's outputs for this `dirm`: the old home-row words at
    CL_LLC_HWAY and CL_LLC_VWAY."""
    if l1.dim() == 2:
        return commit_step_plain(
            cfg, *unsqueeze_all(l1, dirm, tag_rows, shw, vic_shw, lanes, pc_lanes),
            cid, *unsqueeze_all(step_no, counters, delta, hm, wm, cm),
        )
    Bn = l1.shape[0]
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    FS = W1 * S1
    dev = l1.device
    lane = lanes.unbind(-1)
    pl = pc_lanes.unbind(-1)
    stp = step_no[:, None]
    line, hit_way, l1_vway = lane[CL_LINE], lane[CL_HIT_WAY], lane[CL_L1_VWAY]
    st_val, slot = lane[CL_ST_VAL], lane[CL_SLOT]
    llc_hway, llc_vway, oclamp = lane[CL_LLC_HWAY], lane[CL_LLC_VWAY], lane[CL_OCLAMP]
    (hit, write_hit, upg, winner, join, llc_hit, jrep, takes_own, gets_probe,
     gets_shared) = (
        lane[k] != 0
        for k in (CL_HIT, CL_WRITE_HIT, CL_UPG_IN_PLACE, CL_WINNER, CL_JOIN,
                  CL_LLC_HIT, CL_JREP, CL_TAKES_OWN, CL_GETS_PROBE,
                  CL_GETS_SHARED)
    )

    def old(home, vic):
        """The home-row word at the updated way: the hit way's on an LLC
        hit, the victim's otherwise."""
        return torch.where(llc_hit, pl[home], pl[vic])

    # ordered L1 plane writes (later writes win)
    l1s = line & (S1 - 1)
    upd_way = torch.where(upg, hit_way, l1_vway)
    hit_col = hit_way * S1 + l1s
    upd_col = upd_way * S1 + l1s
    fill = (winner & ~upg) | join
    any_tagm, t_way = first_true(tag_rows == line[..., None])
    dup = fill & any_tagm & (t_way != upd_way)
    dup_col = t_way * S1 + l1s
    wj = winner | join
    st_m = write_hit | wj
    st_col = torch.where(write_hit, hit_col, upd_col)
    eph_home = join | llc_hit  # the epoch's way: join ? hway : the updated way
    new_eph = torch.where(eph_home, pl[PL_HOME_EPOCH], pl[PL_VIC_EPOCH]) + takes_own.to(_i32)
    fill_ptr = slot * W2 + torch.where(eph_home, llc_hway, llc_vway)
    _write(l1, dup, dup_col, -1)
    _write(l1, dup, dup_col + FS, I)
    _write(l1, hit | wj, torch.where(hit, hit_col, upd_col) + 2 * FS, stp)
    _write(l1, st_m, st_col + FS, st_val)
    _write(l1, wj, upd_col, line)
    _write(l1, wj, upd_col + 3 * FS, fill_ptr)
    _write(l1, wj, upd_col + 4 * FS, new_eph)
    if hm is not None:
        for k in range(hm.shape[-1]):
            cmk = cm[..., k]
            _write(l1, hm[..., k] != 0, cmk + 2 * FS, stp)
            sup = (wm[..., k] != 0) & ~(st_m & (st_col == cmk))
            _write(l1, sup, cmk + FS, M)

    # directory: a winner's new pair, LRU, epoch and sharer words at the
    # updated way; a joiner's LRU (the join representative) and self bit
    # at the hit way. Each lane adds its delta words to row `slot` of its
    # own element's directory.
    nw = torch.arange(NW, dtype=_i32, device=dev)
    logG = cfg.sharer_group.bit_length() - 1
    g, og = cid >> logG, oclamp >> logG  # sharer bits: the cores' groups
    self_word = torch.where(nw == (g >> 5)[:, None], 1 << (g & 31)[:, None], 0)
    owner_word = torch.where(nw == (og >> 5)[..., None], 1 << (og & 31)[..., None], 0)
    new_owner = torch.where(takes_own, cid, -1)
    probe_word = self_word | owner_word
    if cfg.coherence == "moesi":
        # dirty sharing: a GETS probe leaves the owner recorded and the
        # sharers accumulate (under MESI shw is 0 on a probe anyway)
        new_owner = torch.where(gets_probe, oclamp, new_owner)
        probe_word = shw | probe_word
    new_shw = torch.where(
        gets_probe[..., None],
        probe_word,
        torch.where(gets_shared[..., None], shw | self_word, 0),
    )
    zero = torch.zeros_like(line)
    win_d = torch.cat([
        torch.stack([
            line - old(PL_HOME_TAG, PL_VIC_TAG),
            new_owner - old(PL_OWNER, PL_VIC_OWNER),
            stp - old(PL_HOME_LRU, PL_VIC_LRU),
            new_eph - old(PL_HOME_EPOCH, PL_VIC_EPOCH),
        ], -1),
        new_shw - torch.where(llc_hit[..., None], shw, vic_shw),
    ], -1)
    jdelta = torch.where(jrep, stp - pl[PL_HOME_LRU], 0)
    join_d = torch.cat(
        [torch.stack([zero, zero, jdelta, zero], -1), (self_word & ~shw)], -1
    )
    way = torch.where(winner, torch.where(llc_hit, llc_hway, llc_vway), llc_hway)[..., None]
    cols = torch.cat(
        [2 * way, 2 * way + 1, 2 * W2 + way, 3 * W2 + way, MW + way * NW + nw], -1
    )
    # lanes neither winner nor joiner add zeros (the JAX package drops them)
    vals = torch.where(winner[..., None], win_d, torch.where(join[..., None], join_d, 0))
    dirm.view(Bn, -1).scatter_add_(
        1, (slot.long()[..., None] * DW + cols).view(Bn, -1), vals.reshape(Bn, -1)
    )
    counters += delta


def _check_widths(name: str, cfg: MachineConfig, hm) -> int:
    """The local run length; raise where a core's ways, LLC ways or run
    slots outnumber a warp's lanes."""
    rl = 0 if hm is None else hm.shape[-1]
    for what, n in (("l1.ways", cfg.l1.ways), ("llc.ways", cfg.llc.ways),
                    ("local run length", rl)):
        if n > WARP:
            raise ValueError(f"{name}: {what} = {n} is above {WARP}")
    return rl


def _device(name: str, t) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _run_patch(hm, wm, cm, Bn, C, rl, dev, anchor):
    """The run patch as the kernels read it: `hm` and `wm` as bytes of
    the bool tensors, `cm` through its core stride (element b's row c at
    (b*C + c) * stride). Returns (pointers, cm core stride); rl = 0
    passes a dummy pointer the kernel never reads."""
    if not rl:
        return [anchor] * 3, 0
    check_tensor("hm", hm, (Bn, C, rl), dev, torch.bool)
    check_tensor("wm", wm, (Bn, C, rl), dev, torch.bool)
    if (cm.dtype != _i32 or tuple(cm.shape) != (Bn, C, rl) or cm.device != dev
            or cm.stride(2) != 1 or cm.stride(1) < rl
            or (Bn > 1 and cm.stride(0) != C * cm.stride(1))):
        raise ValueError(
            f"cm must be int32 [{Bn}, {C}, {rl}] on {dev} with unit column stride "
            f"and element stride C * core stride, got {cm.dtype} {list(cm.shape)} "
            f"strides {cm.stride()} on {cm.device}"
        )
    return [hm, wm, cm], cm.stride(1)


def probe_classify(
    cfg: MachineConfig, l1, dirm, slot, line, cid, step_no,
    hm=None, wm=None, cm=None,
):
    """Phase 1 for every core of every element: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. Batched: `l1`
    [B, C, 5*W1*S1], `dirm` [B, NS, DW], `slot`/`line` [B, C], `step_no`
    [B], `hm`/`wm` bool and `cm` int32 [B, C, rl] (a column slice is
    fine); `cid` [C] is shared. Solo shapes (no B) are a batch of one."""
    rl = _check_widths("probe_classify", cfg, hm)
    dev = _device("probe_classify", l1)
    if dev.type == "cpu":
        return probe_classify_plain(cfg, l1, dirm, slot, line, cid, step_no, hm, wm, cm)
    if l1.dim() == 2:
        return squeeze_all(probe_classify(
            cfg, *unsqueeze_all(l1, dirm, slot, line), cid,
            *unsqueeze_all(step_no, hm, wm, cm),
        ))
    Bn, C = l1.shape[0], cfg.n_cores
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    NS = cfg.n_banks * cfg.llc.sets
    check_tensor("l1", l1, (Bn, C, 5 * W1 * S1), dev)
    check_tensor("dirm", dirm, (Bn, NS, DW), dev)
    for name, x in (("slot", slot), ("line", line)):
        check_tensor(name, x, (Bn, C), dev)
    check_tensor("cid", cid, (C,), dev)
    check_tensor("step_no", step_no, (Bn,), dev)
    patch, cm_ld = _run_patch(hm, wm, cm, Bn, C, rl, dev, line)
    outs = [torch.empty(Bn, C, W1, dtype=_i32, device=dev) for _ in range(3)]
    outs += [torch.empty(Bn, C, NW, dtype=_i32, device=dev) for _ in range(2)]
    outs.append(torch.empty(Bn, C, PROBE_LANES, dtype=_i32, device=dev))
    build.launch(
        "probe_classify",
        [l1, dirm, slot, line, cid, step_no, *patch, *outs],
        [Bn, C, NS, S1, W1, W2, NW, MW, DW, rl, cm_ld,
         cfg.sharer_group.bit_length() - 1],
        torch.cuda.current_stream(dev),
    )
    return tuple(outs)


def commit_step(
    cfg: MachineConfig, l1, dirm, tag_rows, shw, vic_shw, lanes, pc_lanes,
    cid, step_no, counters, delta, hm=None, wm=None, cm=None,
) -> None:
    """Phase 4.A + counter fold, in place on `l1`, `dirm` and `counters`:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors.
    `tag_rows`, `shw`, `vic_shw` and `pc_lanes` are probe_classify's
    outputs of this step; the row slot is column CL_SLOT of `lanes`.
    Batched as probe_classify, with `counters`/`delta` [B, NC, C]; solo
    shapes are a batch of one."""
    rl = _check_widths("commit_step", cfg, hm)
    dev = _device("commit_step", l1)
    moesi = cfg.coherence == "moesi"
    if moesi and cfg.sharer_group != 1:
        raise ValueError("commit_step: MOESI needs sharer_group == 1")
    if dev.type == "cpu":
        return commit_step_plain(
            cfg, l1, dirm, tag_rows, shw, vic_shw, lanes, pc_lanes, cid,
            step_no, counters, delta, hm, wm, cm,
        )
    if l1.dim() == 2:
        return commit_step(
            cfg, *unsqueeze_all(l1, dirm, tag_rows, shw, vic_shw, lanes, pc_lanes),
            cid, *unsqueeze_all(step_no, counters, delta, hm, wm, cm),
        )
    Bn, C = l1.shape[0], cfg.n_cores
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    NS = cfg.n_banks * cfg.llc.sets
    NC = counters.shape[1]
    check_tensor("l1", l1, (Bn, C, 5 * W1 * S1), dev)
    check_tensor("dirm", dirm, (Bn, NS, DW), dev)
    check_tensor("tag_rows", tag_rows, (Bn, C, W1), dev)
    check_tensor("shw", shw, (Bn, C, NW), dev)
    check_tensor("vic_shw", vic_shw, (Bn, C, NW), dev)
    check_tensor("lanes", lanes, (Bn, C, COMMIT_LANES), dev)
    check_tensor("pc_lanes", pc_lanes, (Bn, C, PROBE_LANES), dev)
    check_tensor("cid", cid, (C,), dev)
    check_tensor("step_no", step_no, (Bn,), dev)
    check_tensor("counters", counters, (Bn, NC, C), dev)
    check_tensor("delta", delta, (Bn, NC, C), dev)
    patch, cm_ld = _run_patch(hm, wm, cm, Bn, C, rl, dev, lanes)
    build.launch(
        "commit_step",
        [l1, dirm, tag_rows, shw, vic_shw, lanes, pc_lanes, cid, step_no,
         counters, delta, *patch],
        [Bn, C, NS, S1, W1, W2, NW, MW, DW, NC, rl, cm_ld,
         cfg.sharer_group.bit_length() - 1, int(moesi)],
        torch.cuda.current_stream(dev),
    )
