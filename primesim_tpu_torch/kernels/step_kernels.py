"""The two fused step kernels: `probe_classify` (phase 1) and
`commit_step` (phase 4.A plus the counter fold).

They replace the JAX package's Pallas kernels of the same names
(`kernels/step_kernels.py`) and keep their contracts: the same inputs,
the same packed lane columns (PL_* out of the probe, CL_* into the
commit) and the same outputs, bit for bit. Each wrapper runs the CUDA
kernel (`csrc/probe_classify.cu`, `csrc/commit_step.cu`) on CUDA tensors
and the plain torch version below on CPU tensors. Full-map MESI only
(sharer group 1), as `config.machine.check_port_supported` enforces.
"""

from __future__ import annotations

import torch

from ..config.machine import MachineConfig
from ..sim.state import I, M, S, dirm_width, llc_meta_width
from . import build
from .layouts import check_tensor, first_min, first_true, popcount, take

# probe_classify packed-lane indices (column k of the [C, PROBE_LANES] output)
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
) = range(11)
PROBE_LANES = 11

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

_i32 = torch.int32


def probe_classify_plain(
    cfg: MachineConfig, l1, vrows, mrows, line, cid, step_no,
    hm=None, wm=None, cm=None,
):
    """Plain torch version of phase 1: returns (tag_rows, lru_rows, weff)
    [C, W1], (shw, vic_shw) [C, NW] and the lanes [C, PROBE_LANES].
    `vrows` is dirm[ptr // W2] as [C, W1*DW], `mrows` is dirm[slot]."""
    C = l1.shape[0]
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    FS = W1 * S1
    dev = l1.device
    l1s = line & (S1 - 1)
    w1cols = torch.arange(W1, dtype=_i32, device=dev)[None, :] * S1 + l1s[:, None]
    planes = l1.gather(
        1, torch.cat([w1cols + p * FS for p in range(4)], 1).long()
    )
    tag_w, st_w, lru_w, ptr_w = planes.split(W1, 1)
    if hm is not None:
        # the local run's deferred L1 writes, patched in: E->M at wm
        # columns, LRU stamps at hm columns
        colm = cm[:, :, None] == w1cols[:, None, :]  # [C, rl, W1]
        st_w = torch.where(((wm[:, :, None] != 0) & colm).any(1), M, st_w)
        lru_w = torch.where(((hm[:, :, None] != 0) & colm).any(1), step_no, lru_w)

    # pointer validation of every way against its directory entry
    pway = ptr_w % W2
    vr = vrows.view(C, W1, DW)
    vtag = take(vr, 2 * pway)
    vown = take(vr, 2 * pway + 1)
    vsh = take(vr, MW + pway * NW + (cid[:, None] >> 5))
    vbit = ((vsh >> (cid[:, None] & 31)) & 1) != 0
    weff = torch.where(
        (st_w == I) | (vtag != tag_w),
        I,
        torch.where(vown == cid[:, None], st_w, torch.where(vbit, S, I)),
    ).to(_i32)

    hit_any, hit_way = first_true((tag_w == line[:, None]) & (weff != I))
    hit_state = take(weff, hit_way)

    # LLC home-row parse
    ltag = mrows[:, 0 : 2 * W2 : 2]
    lown = mrows[:, 1 : 2 * W2 : 2]
    llc_has, llc_hway = first_true(ltag == line[:, None])
    owner = take(lown, llc_hway)
    sh_rows = mrows[:, MW:].view(C, W2, NW)
    nw_idx = torch.arange(NW, device=dev)
    shw = sh_rows[torch.arange(C, device=dev)[:, None], llc_hway.long()[:, None], nw_idx]
    self_bit = (take(shw, cid >> 5) >> (cid & 31)) & 1
    other_sh = (popcount(shw).sum(1, dtype=_i32) - self_bit) > 0

    # victim: first minimum of LRU over valid ways
    vkey = torch.where(ltag != -1, mrows[:, 2 * W2 : 3 * W2], -1)
    llc_vway = first_min(vkey)
    vic_shw = sh_rows[torch.arange(C, device=dev)[:, None], llc_vway.long()[:, None], nw_idx]
    lanes = torch.stack(
        [
            hit_any.to(_i32), hit_way, hit_state, llc_has.to(_i32), llc_hway,
            owner, self_bit, other_sh.to(_i32), take(ltag, llc_vway),
            take(lown, llc_vway), llc_vway,
        ],
        1,
    )
    return tag_w, lru_w, weff, shw, vic_shw, lanes


def _write(blk, mask, col, val):
    """blk[c, col[c]] = val[c] where mask[c]: one ordered plane write
    (each row gets at most one column, so the scatter is deterministic)."""
    col = torch.where(mask, col, 0).long()[:, None]
    cur = blk.gather(1, col)
    val = torch.as_tensor(val, dtype=_i32, device=blk.device).expand(cur.shape[0])
    blk.scatter_(1, col, torch.where(mask[:, None], val[:, None], cur))


def commit_step_plain(
    cfg: MachineConfig, l1, mrows, tag_rows, shw, lanes, cid, step_no,
    counters, delta, hm=None, wm=None, cm=None,
):
    """Plain torch version of phase 4.A + the counter fold: returns
    (l1_new [C, 5*W1*S1], delta_row [C, DW], counters_new [NC, C])."""
    C = l1.shape[0]
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    FS = W1 * S1
    dev = l1.device
    lane = lanes.unbind(1)
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

    # ordered L1 plane writes (later writes win)
    l1s = line & (S1 - 1)
    upd_way = torch.where(upg, hit_way, l1_vway)
    hit_col = hit_way * S1 + l1s
    upd_col = upd_way * S1 + l1s
    fill = (winner & ~upg) | join
    any_tagm, t_way = first_true(tag_rows == line[:, None])
    dup = fill & any_tagm & (t_way != upd_way)
    dup_col = t_way * S1 + l1s
    wj = winner | join
    st_m = write_hit | wj
    st_col = torch.where(write_hit, hit_col, upd_col)
    llc_uway = torch.where(llc_hit, llc_hway, llc_vway)
    eph_way = torch.where(join, llc_hway, llc_uway)
    new_eph = take(mrows, 3 * W2 + eph_way) + takes_own.to(_i32)
    fill_ptr = slot * W2 + torch.where(join | llc_hit, llc_hway, llc_vway)
    blk = l1.clone()
    _write(blk, dup, dup_col, -1)
    _write(blk, dup, dup_col + FS, I)
    _write(blk, hit | wj, torch.where(hit, hit_col, upd_col) + 2 * FS, step_no)
    _write(blk, st_m, st_col + FS, st_val)
    _write(blk, wj, upd_col, line)
    _write(blk, wj, upd_col + 3 * FS, fill_ptr)
    _write(blk, wj, upd_col + 4 * FS, new_eph)
    if hm is not None:
        for k in range(hm.shape[1]):
            cmk = cm[:, k]
            _write(blk, hm[:, k] != 0, cmk + 2 * FS, step_no)
            sup = (wm[:, k] != 0) & ~(st_m & (st_col == cmk))
            _write(blk, sup, cmk + FS, M)

    # directory row delta
    nw = torch.arange(NW, dtype=_i32, device=dev)[None, :]
    self_word = torch.where(nw == (cid >> 5)[:, None], 1 << (cid & 31)[:, None], 0)
    owner_word = torch.where(nw == (oclamp >> 5)[:, None], 1 << (oclamp & 31)[:, None], 0)
    new_owner = torch.where(takes_own, cid, -1)
    new_shw = torch.where(
        gets_probe[:, None],
        self_word | owner_word,
        torch.where(gets_shared[:, None], shw | self_word, 0),
    )
    join_word = self_word & ~shw
    j = torch.arange(DW, dtype=_i32, device=dev)[None, :]
    jsh = (j - MW).clamp(min=0)
    w_sh, n_sh = jsh // NW, (jsh % NW).long().expand(C, DW)
    uw = llc_uway[:, None]
    pairv = torch.where((j & 1) == 0, line[:, None], new_owner[:, None])
    new_full = torch.where(
        j < 2 * W2,
        torch.where((j >> 1) == uw, pairv, mrows),
        torch.where(
            j < 3 * W2,
            torch.where(j - 2 * W2 == uw, step_no, mrows),
            torch.where(
                j < 4 * W2,
                torch.where(j - 3 * W2 == uw, new_eph[:, None], mrows),
                torch.where(
                    (j >= MW) & (w_sh == uw), new_shw.gather(1, n_sh), mrows
                ),
            ),
        ),
    )
    hw = llc_hway[:, None]
    jdelta = torch.where(jrep, step_no - take(mrows, 2 * W2 + llc_hway), 0)
    join_row = torch.where(j == 2 * W2 + hw, jdelta[:, None], 0) + torch.where(
        (j >= MW) & (w_sh == hw), join_word.gather(1, n_sh), 0
    )
    drow = torch.where(
        winner[:, None], new_full - mrows, torch.where(join[:, None], join_row, 0)
    ).to(_i32)
    return blk, drow, counters + delta


def _run_patch(hm, wm, cm, C, dev, anchor):
    """The run-patch inputs as contiguous int32 [C, rl] tensors (rl = 0:
    a dummy pointer the kernel never reads)."""
    if hm is None:
        return 0, [anchor] * 3
    rl = hm.shape[1]
    out = [x.to(_i32).contiguous() for x in (hm, wm, cm)]
    for name, x in zip(("hm", "wm", "cm"), out):
        check_tensor(name, x, (C, rl), dev)
    return rl, out


def probe_classify(
    cfg: MachineConfig, l1, vrows, mrows, line, cid, step_no,
    hm=None, wm=None, cm=None,
):
    """Phase 1 for every core: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. `step_no` is a 0-d int32 tensor."""
    dev = l1.device
    if dev.type == "cpu":
        return probe_classify_plain(cfg, l1, vrows, mrows, line, cid, step_no, hm, wm, cm)
    if dev.type != "cuda":
        raise ValueError(f"probe_classify: unsupported device {dev}")
    C = cfg.n_cores
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    check_tensor("l1", l1, (C, 5 * W1 * S1), dev)
    check_tensor("vrows", vrows, (C, W1 * DW), dev)
    check_tensor("mrows", mrows, (C, DW), dev)
    check_tensor("line", line, (C,), dev)
    check_tensor("cid", cid, (C,), dev)
    check_tensor("step_no", step_no, (), dev)
    rl, patch = _run_patch(hm, wm, cm, C, dev, line)
    outs = [torch.empty(C, W1, dtype=_i32, device=dev) for _ in range(3)]
    outs += [torch.empty(C, NW, dtype=_i32, device=dev) for _ in range(2)]
    outs.append(torch.empty(C, PROBE_LANES, dtype=_i32, device=dev))
    build.launch(
        "probe_classify",
        [l1, vrows, mrows, line, cid, step_no, *patch, *outs],
        [C, S1, W1, W2, NW, MW, DW, rl],
        torch.cuda.current_stream(dev),
    )
    return tuple(outs)


def commit_step(
    cfg: MachineConfig, l1, mrows, tag_rows, shw, lanes, cid, step_no,
    counters, delta, hm=None, wm=None, cm=None,
):
    """Phase 4.A + counter fold: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. The caller applies the one remaining
    row scatter: dirm[upd_slot] += delta_row."""
    dev = l1.device
    if dev.type == "cpu":
        return commit_step_plain(
            cfg, l1, mrows, tag_rows, shw, lanes, cid, step_no, counters,
            delta, hm, wm, cm,
        )
    if dev.type != "cuda":
        raise ValueError(f"commit_step: unsupported device {dev}")
    C = cfg.n_cores
    S1, W1, W2 = cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    NC = counters.shape[0]
    check_tensor("l1", l1, (C, 5 * W1 * S1), dev)
    check_tensor("mrows", mrows, (C, DW), dev)
    check_tensor("tag_rows", tag_rows, (C, W1), dev)
    check_tensor("shw", shw, (C, NW), dev)
    check_tensor("lanes", lanes, (C, COMMIT_LANES), dev)
    check_tensor("cid", cid, (C,), dev)
    check_tensor("step_no", step_no, (), dev)
    check_tensor("counters", counters, (NC, C), dev)
    check_tensor("delta", delta, (NC, C), dev)
    rl, patch = _run_patch(hm, wm, cm, C, dev, lanes)
    l1_new = torch.empty_like(l1)
    drow = torch.empty(C, DW, dtype=_i32, device=dev)
    cnt = torch.empty_like(counters)
    build.launch(
        "commit_step",
        [l1, mrows, tag_rows, shw, lanes, cid, step_no, counters, delta,
         *patch, l1_new, drow, cnt],
        [C, S1, W1, W2, NW, MW, DW, NC, rl],
        torch.cuda.current_stream(dev),
    )
    return l1_new, drow, cnt
