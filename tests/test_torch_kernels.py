"""The port's kernels against the JAX package's Pallas kernels.

Each Pallas kernel runs as the JAX package's own tests run it on the CPU
(interpret mode); the port's plain versions, which the CUDA kernels are
held against on the card (chip_smoke.py), take the same inputs made from
a numpy seed. Integer simulator, so every comparison is exact: the
tolerance is 0. Shapes: 8 cores (one sharer word) and 64 cores (two
words, crossing the word boundary), local-run lengths 0, 2 and 8, with
sharer words that use bit 31 and with tied tags and LRU stamps; the
reductions also on victim owners that are recorded sharers, self bits,
padding bits above C, bit 31 in every word and rows with every bit set.

The port's step kernels read and update the directory `dirm` itself,
where the JAX package's are handed staged rows: the probe cases stage
`dirm[ptr // W2]` and `dirm[slot]` from the same numpy `dirm` for the
Pallas kernel, and the commit cases follow the Pallas kernel with the JAX
engine's `dirm.at[upd_slot].add(delta_row, mode="drop")`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import CacheConfig as JCache
from primesim_tpu.config.machine import MachineConfig as JCfg
from primesim_tpu.config.machine import NocConfig as JNoc
from primesim_tpu.kernels.reductions import sharer_reductions as j_reduce
from primesim_tpu.kernels.step_kernels import commit_step as j_commit
from primesim_tpu.kernels.step_kernels import probe_classify as j_probe
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.kernels import build, layouts, reductions, step_kernels
from primesim_tpu_torch.kernels.step_kernels import (
    CL_JOIN,
    CL_LINE,
    CL_LLC_HIT,
    CL_LLC_HWAY,
    CL_LLC_VWAY,
    CL_SLOT,
    CL_WINNER,
    PL_HOME_EPOCH,
    PL_HOME_LRU,
    PL_HOME_TAG,
    PL_LLC_HWAY,
    PL_LLC_VWAY,
    PL_OTHER_SH,
    PL_OWNER,
    PL_SELF_BIT,
    PL_VIC_EPOCH,
    PL_VIC_LRU,
    PL_VIC_OWNER,
    PL_VIC_TAG,
)
from primesim_tpu_torch.sim.state import dirm_width, llc_meta_width

JAX_PROBE_LANES = 11  # the JAX package's lanes; the port appends five


def _cfgs(C, l1_ways=None, llc_ways=None):
    if C == 8:
        w1, w2 = l1_ways or 2, llc_ways or 4
        j = JCfg(
            n_cores=8, n_banks=4,
            l1=JCache(512 * w1, w1, 64, 2), llc=JCache(1024 * w2, w2, 64, 10),
            noc=JNoc(mesh_x=2, mesh_y=2), quantum=300,
        )
    else:
        j = JCfg(
            n_cores=64, n_banks=16,
            l1=JCache(2048, 4, 64, 2), llc=JCache(8192, 8, 64, 10),
            noc=JNoc(mesh_x=4, mesh_y=4), quantum=500,
        )
    return j, TCfg.from_json(j.to_json())


def _words(rng, shape):
    """Random 32-bit sharer words as int32, many with bit 31 set."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


def _t(a):
    """A torch copy of a numpy array (the port's commit writes in place)."""
    return torch.from_numpy(np.array(a, copy=True))


def _both(arrs):
    """(jax-side numpy arrays, port torch tensors) of the same inputs."""
    return arrs, [_t(a) for a in arrs]


def _assert_same(j_out, t_out, names):
    assert len(j_out) == len(t_out) == len(names)
    for n, a, b in zip(names, j_out, t_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=n)


def _dirm(rng, cfg, n_lines):
    """A random directory [NS, DW]: tags among `n_lines` lines or -1,
    owners among the cores or -1, small LRU and epoch stamps (ties),
    random sharer words."""
    NS, W2, C = cfg.n_banks * cfg.llc.sets, cfg.llc.ways, cfg.n_cores
    MW, DW = llc_meta_width(cfg), dirm_width(cfg)
    r = np.zeros((NS, DW), np.int32)
    r[:, 0 : 2 * W2 : 2] = rng.integers(-1, n_lines, (NS, W2))
    r[:, 1 : 2 * W2 : 2] = rng.integers(-1, C, (NS, W2))
    r[:, 2 * W2 : 3 * W2] = rng.integers(0, 3, (NS, W2))
    r[:, 3 * W2 : 4 * W2] = rng.integers(0, 3, (NS, W2))
    r[:, MW:] = _words(rng, (NS, W2 * cfg.n_sharer_words))
    return r


def _run_patch(rng, cfg, line, rl):
    """hm, wm (int32 0/1) and cm [C, rl], half the run columns inside the
    accessed set."""
    C, S1, W1 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways
    return [
        rng.integers(0, 2, (C, rl)).astype(np.int32),
        rng.integers(0, 2, (C, rl)).astype(np.int32),
        np.where(
            rng.random((C, rl)) < 0.5,
            rng.integers(0, W1, (C, rl)) * S1 + (line & (S1 - 1))[:, None],
            rng.integers(0, W1 * S1, (C, rl)),
        ).astype(np.int32),
    ]


def _probe_inputs(cfg, seed, rl):
    """l1, dirm, slot, line, cid, step (and the run patch): the port's
    probe arguments. Core 0's home row is the last directory row, and core
    1's way 0 points at the last row's last way."""
    rng = np.random.default_rng(seed)
    C, S1, W1, W2 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NS = cfg.n_banks * cfg.llc.sets
    FS = W1 * S1
    n_lines = 6  # few lines: tags tie across ways and hit often
    l1 = np.concatenate(
        [
            rng.integers(-1, n_lines, (C, FS)),  # tags
            rng.integers(0, 4, (C, FS)),  # MESI
            rng.integers(0, 4, (C, FS)),  # LRU stamps, many ties
            rng.integers(0, NS * W2, (C, FS)),  # ptr
            rng.integers(0, 3, (C, FS)),  # epoch
        ],
        axis=1,
    ).astype(np.int32)
    dirm = _dirm(rng, cfg, n_lines)
    line = rng.integers(0, n_lines, C).astype(np.int32)
    slot = rng.integers(0, NS, C).astype(np.int32)
    slot[0] = NS - 1
    cid = np.arange(C, dtype=np.int32)
    w1cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
    rows = np.arange(C)[:, None]
    # a third of the cores hold the accessed line in some way
    hc = np.nonzero(rng.random(C) < 0.35)[0]
    l1[hc, w1cols[hc, rng.integers(0, W1, len(hc))]] = line[hc]
    l1[1, 3 * FS + w1cols[1, 0]] = NS * W2 - 1
    ptr = l1[rows, 3 * FS + w1cols]
    # half the ways' pointers name an entry whose tag matches (a live
    # copy), and a third of those name the core itself as owner
    cc, ww = np.nonzero(rng.random((C, W1)) < 0.5)
    prow, pway = ptr[cc, ww] // W2, ptr[cc, ww] % W2
    dirm[prow, 2 * pway] = l1[cc, w1cols[cc, ww]]
    own = rng.random(len(cc)) < 0.3
    dirm[prow[own], 2 * pway[own] + 1] = cc[own]
    step = np.asarray(rng.integers(0, 1000), np.int32)
    arrs = [l1, dirm, slot, line, cid, step]
    if rl:
        arrs += _run_patch(rng, cfg, line, rl)
    return arrs


def _stage(cfg, l1, dirm, slot, line):
    """What the JAX engine stages for its probe: vrows = dirm[ptr // W2]
    of the accessed set's ways as [C, W1*DW], mrows = dirm[slot]."""
    C, S1, W1, W2 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    FS = W1 * S1
    w1cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
    ptr = l1[np.arange(C)[:, None], 3 * FS + w1cols]
    return dirm[ptr // W2].reshape(C, -1), dirm[slot]


def _bool_patch(t_in, at):
    """The port's arguments with the run patch's hm, wm (at `at`, when
    there is a run) as bool, as the engine hands them over; the JAX
    kernels take int32."""
    if len(t_in) > at:
        t_in[at : at + 2] = [t_in[at] != 0, t_in[at + 1] != 0]
    return t_in


def _probe_both(jcfg, tcfg, arrs):
    """(JAX outputs, port outputs, staged mrows) of one probe."""
    l1, dirm, slot, line, cid, step = arrs[:6]
    vrows, mrows = _stage(jcfg, l1, dirm, slot, line)
    j_out = j_probe(jcfg, l1, vrows, mrows, line, cid, step, *arrs[6:])
    t_out = step_kernels.probe_classify(tcfg, *_bool_patch(_both(arrs)[1], 6))
    return j_out, t_out, mrows


def _check_probe(jcfg, j_out, t_out, mrows):
    """The port's outputs equal the Pallas kernel's, and its five
    appended lanes equal the staged home-row words."""
    _assert_same(j_out[:5], t_out[:5], ["tag", "lru", "weff", "shw", "vic_shw"])
    lanes = t_out[5].numpy()
    np.testing.assert_array_equal(lanes[:, :JAX_PROBE_LANES], np.asarray(j_out[5]))
    W2 = jcfg.llc.ways
    rows = np.arange(jcfg.n_cores)
    hway, vway = lanes[:, PL_LLC_HWAY], lanes[:, PL_LLC_VWAY]
    for lane, col in (
        (PL_HOME_TAG, 2 * hway), (PL_HOME_LRU, 2 * W2 + hway),
        (PL_HOME_EPOCH, 3 * W2 + hway), (PL_VIC_LRU, 2 * W2 + vway),
        (PL_VIC_EPOCH, 3 * W2 + vway),
    ):
        np.testing.assert_array_equal(lanes[:, lane], mrows[rows, col], err_msg=str(lane))
    return lanes


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 2, 8])
def test_probe_classify_matches_pallas(C, rl):
    jcfg, tcfg = _cfgs(C)
    lanes = _check_probe(jcfg, *_probe_both(jcfg, tcfg, _probe_inputs(jcfg, 100 + C + rl, rl)))
    # the inputs reach every classification branch
    assert lanes[:, step_kernels.PL_HIT_ANY].any()
    assert not lanes[:, step_kernels.PL_HIT_ANY].all()
    assert lanes[:, step_kernels.PL_LLC_HAS].any()
    assert lanes[:, PL_SELF_BIT].any()


@pytest.mark.parametrize("C", [8, 64])
def test_probe_classify_reads_the_last_dirm_row(C):
    """Core 1's way 0 points at the last row's last way, and core 0's home
    row is the last row: both read the row's last words."""
    jcfg, tcfg = _cfgs(C)
    W2 = jcfg.llc.ways
    NS = jcfg.n_banks * jcfg.llc.sets
    arrs = _probe_inputs(jcfg, 40 + C, 2)
    l1, dirm, slot, line = arrs[:4]
    FS = jcfg.l1.ways * jcfg.l1.sets
    col = line[1] & (jcfg.l1.sets - 1)  # way 0 of core 1's accessed set
    assert l1[1, 3 * FS + col] == NS * W2 - 1 and slot[0] == NS - 1
    # a live copy of core 1's whose validation rests on that last way
    l1[1, col], l1[1, FS + col] = line[1], 2  # tag, E
    dirm[NS - 1, 2 * (W2 - 1) : 2 * W2] = [line[1], 1]  # tag, owner core 1
    lanes = _check_probe(jcfg, *_probe_both(jcfg, tcfg, arrs))
    assert lanes[1, step_kernels.PL_HIT_ANY] == 1 and lanes[1, step_kernels.PL_HIT_WAY] == 0


def _commit_inputs(cfg, seed, rl):
    """The port's commit arguments: l1, dirm, tag_rows, shw, vic_shw,
    lanes, pc_lanes, cid, step, counters, delta (and the run patch).
    Slots come from a small pool, so winners and joiners share rows;
    `shw`, `vic_shw` and the home-row lanes are the probe's words of
    `dirm` at each core's hit and victim ways."""
    rng = np.random.default_rng(seed)
    C, S1, W1, W2 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW = cfg.n_sharer_words, llc_meta_width(cfg)
    NS = cfg.n_banks * cfg.llc.sets
    FS = W1 * S1
    n_lines = 6
    l1 = rng.integers(-5, 50, (C, 5 * FS)).astype(np.int32)
    # the full int32 range: row deltas and counter folds must wrap
    dirm = rng.integers(-(2**31), 2**31, (NS, dirm_width(cfg)), dtype=np.int64).astype(np.int32)
    pool = rng.choice(NS, size=max(2, C // 4), replace=False)
    slot = rng.choice(pool, C).astype(np.int32)
    hway = rng.integers(0, W2, C).astype(np.int32)
    vway = rng.integers(0, W2, C).astype(np.int32)
    tag_rows = rng.integers(-1, n_lines, (C, W1)).astype(np.int32)
    flags = rng.integers(0, 2, (C, 18))
    lanes = np.stack(
        [
            rng.integers(0, n_lines, C),  # line
            rng.integers(0, W1, C),  # hit_way
            rng.integers(0, W1, C),  # l1_vway
            flags[:, 3], flags[:, 4], flags[:, 5], flags[:, 6], flags[:, 7],
            flags[:, 8],
            rng.integers(0, 4, C),  # st_val
            slot, hway, vway,
            flags[:, 13], flags[:, 14], flags[:, 15], flags[:, 16],
            rng.integers(0, C, C),  # oclamp
        ],
        axis=1,
    ).astype(np.int32)
    cid = np.arange(C, dtype=np.int32)
    step = np.asarray(rng.integers(0, 1000), np.int32)
    counters = rng.integers(-(2**31), 2**31, (26, C), dtype=np.int64).astype(np.int32)
    delta = rng.integers(0, 2**30, (26, C)).astype(np.int32)
    arrs = [l1, dirm, tag_rows, None, None, lanes, None, cid, step, counters, delta]
    if rl:
        arrs += _run_patch(rng, cfg, lanes[:, CL_LINE], rl)
    return _restage(cfg, arrs)


def _restage(cfg, arrs):
    """Refresh shw, vic_shw and the home-row probe lanes from `dirm` and
    the lanes' slot, hit way and victim way (after a test edits them)."""
    C, W2, NW = cfg.n_cores, cfg.llc.ways, cfg.n_sharer_words
    MW = llc_meta_width(cfg)
    dirm, lanes = arrs[1], arrs[5]
    mrows = dirm[lanes[:, CL_SLOT]]
    hway, vway = lanes[:, CL_LLC_HWAY], lanes[:, CL_LLC_VWAY]
    rows, nw = np.arange(C)[:, None], np.arange(NW)[None, :]
    pc = np.full((C, step_kernels.PROBE_LANES), 7, np.int32)  # unread lanes
    for lane, col in (
        (PL_OWNER, 2 * hway + 1), (PL_VIC_TAG, 2 * vway), (PL_VIC_OWNER, 2 * vway + 1),
        (PL_HOME_TAG, 2 * hway), (PL_HOME_LRU, 2 * W2 + hway),
        (PL_HOME_EPOCH, 3 * W2 + hway), (PL_VIC_LRU, 2 * W2 + vway),
        (PL_VIC_EPOCH, 3 * W2 + vway),
    ):
        pc[:, lane] = mrows[rows[:, 0], col]
    pc[:, PL_LLC_HWAY], pc[:, PL_LLC_VWAY] = hway, vway
    arrs[3] = mrows[rows, MW + hway[:, None] * NW + nw]
    arrs[4] = mrows[rows, MW + vway[:, None] * NW + nw]
    arrs[6] = pc
    return arrs


def _commit_both(jcfg, tcfg, arrs):
    """(JAX l1, dirm, counters) after the Pallas commit and the JAX
    engine's drop scatter, and the port's in-place tensors."""
    l1, dirm, tag_rows, shw, _, lanes, _, cid, step, counters, delta = arrs[:11]
    NS = jcfg.n_banks * jcfg.llc.sets
    slot = lanes[:, CL_SLOT]
    j_l1, drow, j_cnt = j_commit(
        jcfg, l1, dirm[slot], tag_rows, shw, lanes, cid, step, counters, delta,
        *arrs[11:],
    )
    wj = (lanes[:, CL_WINNER] != 0) | (lanes[:, CL_JOIN] != 0)
    upd_slot = np.where(wj, slot, NS)
    j_dirm = jnp.asarray(dirm).at[upd_slot].add(drow, mode="drop")
    t_in = _bool_patch(_both(arrs)[1], 11)
    assert step_kernels.commit_step(tcfg, *t_in) is None
    return (j_l1, j_dirm, j_cnt), (t_in[0], t_in[1], t_in[9])


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 2, 8])
def test_commit_step_matches_pallas(C, rl):
    jcfg, tcfg = _cfgs(C)
    arrs = _commit_inputs(jcfg, 200 + C + rl, rl)
    j_out, t_out = _commit_both(jcfg, tcfg, arrs)
    _assert_same(j_out, t_out, ["l1", "dirm", "counters"])
    # the folded counters wrapped somewhere, as int32 must; rows changed
    assert (t_out[2].numpy() < arrs[9]).any()
    assert (t_out[1].numpy() != arrs[1]).any()


@pytest.mark.parametrize("C", [8, 64])
def test_commit_step_winner_and_joiners_on_one_slot(C):
    """One row takes a winner's delta (a miss filling the victim way) and
    two joiners' self bits and LRU delta; another row takes joiners only."""
    jcfg, tcfg = _cfgs(C)
    W2 = jcfg.llc.ways
    arrs = _commit_inputs(jcfg, 60 + C, 2)
    lanes = arrs[5]
    s0, s1 = lanes[0, CL_SLOT], lanes[1, CL_SLOT]
    lanes[:, CL_WINNER] = lanes[:, CL_JOIN] = 0  # the rest drop
    lanes[[0, 2, 3], CL_SLOT] = s0
    lanes[0, [CL_WINNER, CL_LLC_HIT, CL_LLC_VWAY]] = [1, 0, W2 - 1]
    lanes[[2, 3], CL_JOIN] = 1
    lanes[[2, 3], CL_LLC_HWAY] = 0
    lanes[[4, 5], CL_SLOT] = s1
    lanes[[4, 5], CL_JOIN] = 1
    lanes[[4, 5], CL_LLC_HWAY] = W2 - 1
    j_out, t_out = _commit_both(jcfg, tcfg, _restage(jcfg, arrs))
    _assert_same(j_out, t_out, ["l1", "dirm", "counters"])
    changed = np.nonzero((t_out[1].numpy() != arrs[1]).any(1))[0]
    assert set(changed) <= {s0, s1} and s0 in changed


def test_sharer_bit_31():
    """Cores 31 and 63 own bit 31 of sharer words 0 and 1: the probe's
    self bit and other-sharer test and the commit's join bit use it."""
    jcfg, tcfg = _cfgs(64)
    W2, NW, MW = jcfg.llc.ways, jcfg.n_sharer_words, llc_meta_width(jcfg)
    arrs = _probe_inputs(jcfg, 31, 0)
    l1, dirm, slot, line = arrs[:4]
    for c in (31, 63):
        dirm[slot[c], 0 : 2 * W2 : 2] = -1
        dirm[slot[c], 0] = line[c]  # home way 0 holds the line
        dirm[slot[c], MW : MW + NW] = 0
        dirm[slot[c], MW + c // 32] = np.int32(-(2**31))  # bit 31 only
    slot[63] = slot[31] + 1 if slot[31] + 1 < len(dirm) else slot[31] - 1
    dirm[slot[63]] = dirm[slot[31]]
    dirm[slot[63], 0] = line[63]
    dirm[slot[63], MW : MW + NW] = [0, np.int32(-(2**31))]
    lanes = _check_probe(jcfg, *_probe_both(jcfg, tcfg, arrs))
    for c in (31, 63):
        assert lanes[c, PL_SELF_BIT] == 1 and lanes[c, PL_OTHER_SH] == 0
    # the commit: cores 31 and 63 join a row whose sharer words are 0, so
    # each adds its bit 31
    carrs = _commit_inputs(jcfg, 32, 0)
    cl, cdirm = carrs[5], carrs[1]
    cl[:, CL_WINNER] = cl[:, CL_JOIN] = 0
    cl[[31, 63], CL_JOIN] = 1
    cl[[31, 63], CL_SLOT] = cl[31, CL_SLOT]
    cl[[31, 63], CL_LLC_HWAY] = 0
    cdirm[cl[31, CL_SLOT], MW : MW + NW] = 0
    j_out, t_out = _commit_both(jcfg, tcfg, _restage(jcfg, carrs))
    _assert_same(j_out, t_out, ["l1", "dirm", "counters"])
    words = t_out[1].numpy()[cl[31, CL_SLOT], MW : MW + NW]
    assert list(words.view(np.uint32)) == [1 << 31, 1 << 31]


SHARER_CASES = [
    pytest.param(C, case, id=f"{case}-{C}" if case != "random" else str(C))
    for case in ("random", "owner_is_sharer", "self_bit", "padding_bits",
                 "bit31_every_word", "all_bits_row")
    for C in ((8,) if case == "padding_bits" else (8, 64))
]


@pytest.mark.parametrize("C,case", SHARER_CASES)
def test_sharer_reductions_matches_pallas(C, case):
    """Random rows, then one case each: a victim owner that is also a
    recorded sharer (counted once), the self bit in the invalidation
    words (never counted), padding bits of targets >= C (8 cores: bits
    8-31, and owners among them), bit 31 in every word, and rows with all
    32*NW bits set."""
    jcfg, tcfg = _cfgs(C)
    rng = np.random.default_rng(300 + C)
    NW = jcfg.n_sharer_words
    shw, vic_shw = _words(rng, (C, NW)), _words(rng, (C, NW))
    vic_owner = rng.integers(-1, C, C)
    inv_row, vic_valid = rng.random(C) < 0.5, rng.random(C) < 0.5
    cid = np.arange(C)
    if case == "owner_is_sharer":
        vic_valid[:] = True
        vic_owner = rng.integers(0, C, C)
        vic_shw[cid, vic_owner // 32] |= (1 << (vic_owner % 32)).astype(np.uint32).view(np.int32)
    elif case == "self_bit":
        inv_row[:] = True
        shw[cid, cid // 32] |= (1 << (cid % 32)).astype(np.uint32).view(np.int32)
    elif case == "padding_bits":
        inv_row[:] = vic_valid[:] = True
        pad = np.int32(-(1 << C))  # bits C..31 of the one word
        shw[:, 0] |= pad
        vic_shw[:, 0] |= pad
        vic_owner[::2] = rng.integers(C, 32, (C + 1) // 2)
    elif case == "bit31_every_word":
        inv_row[:] = vic_valid[:] = True
        shw |= np.int32(-(2**31))
        vic_shw |= np.int32(-(2**31))
    elif case == "all_bits_row":
        full = rng.random(C) < 0.5
        shw[full] = vic_shw[full] = -1
        inv_row[full] = vic_valid[full] = True
    arrs = [
        shw, vic_shw,
        rng.integers(0, jcfg.n_tiles, C).astype(np.int32),  # btile
        vic_owner.astype(np.int32), inv_row, vic_valid, cid.astype(np.int32),
        np.asarray(3, np.int32),  # link latency
        np.asarray(2, np.int32),  # router latency
    ]
    j_in, t_in = _both(arrs)
    j_out = j_reduce(jcfg, *j_in)
    t_out = reductions.sharer_reductions(tcfg, *t_in)
    _assert_same(
        j_out, t_out, ["inv_lat", "inv_cnt", "inv_hops", "back_cnt", "back_hops"]
    )
    assert t_out[1].numpy().max() > 0 and t_out[3].numpy().max() > 0
    cnt = t_out[1].numpy()
    if case == "all_bits_row":
        assert cnt[full].max() == C - 1  # every target but the core itself
    if case == "padding_bits":
        assert cnt.max() <= C - 1 and t_out[3].numpy().max() <= C


def test_popcount_counts_bit_31():
    rng = np.random.default_rng(1)
    w = np.concatenate(
        [_words(rng, 1000), np.array([-1, -(2**31), 2**31 - 1, 0], np.int32)]
    )
    want = np.array([bin(int(x) & 0xFFFFFFFF).count("1") for x in w])
    got = layouts.popcount(torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_true_and_first_min_take_the_first_tie():
    m = torch.tensor([[0, 1, 1], [0, 0, 0], [1, 1, 1]], dtype=torch.bool)
    any_, idx = layouts.first_true(m)
    assert any_.tolist() == [True, False, True]
    assert idx.tolist() == [1, 0, 0]
    v = torch.tensor([[3, -1, -1], [2, 2, 2], [5, 4, 4]], dtype=torch.int32)
    assert layouts.first_min(v).tolist() == [1, 0, 1]
    np.testing.assert_array_equal(
        layouts.first_min(v).numpy(), np.argmin(v.numpy(), axis=1)
    )


def test_plain_path_counts_no_launch():
    """Only `build.launch` counts, so CPU tensors leave the counts alone."""
    assert set(build.LAUNCHES) == set(build.KERNELS)
    before = dict(build.LAUNCHES)
    jcfg, tcfg = _cfgs(8)
    _probe_both(jcfg, tcfg, _probe_inputs(jcfg, 11, 2))
    _commit_both(jcfg, tcfg, _commit_inputs(jcfg, 12, 2))
    assert build.LAUNCHES == before


def test_wrappers_raise_on_a_device_without_kernels():
    jcfg, tcfg = _cfgs(8)
    t_in = [t.to("meta") for t in _both(_probe_inputs(jcfg, 7, 0))[1]]
    with pytest.raises(ValueError, match="unsupported device"):
        step_kernels.probe_classify(tcfg, *t_in)


def test_commit_step_raises_on_a_device_without_kernels():
    jcfg, tcfg = _cfgs(8)
    t_in = [t.to("meta") for t in _both(_commit_inputs(jcfg, 7, 0))[1]]
    with pytest.raises(ValueError, match="unsupported device"):
        step_kernels.commit_step(tcfg, *t_in)


@pytest.mark.parametrize("wide", ["l1.ways", "llc.ways", "local run length"])
@pytest.mark.parametrize("kernel", ["probe_classify", "commit_step"])
def test_wrappers_raise_above_one_warp_of_lanes(kernel, wide):
    """A core's ways, LLC ways and run slots get one lane each, so each is
    at most 32; the wrappers raise on any device, before dispatch."""
    jcfg, tcfg = _cfgs(
        8, l1_ways=64 if wide == "l1.ways" else None,
        llc_ways=64 if wide == "llc.ways" else None,
    )
    base, _ = _cfgs(8)
    rl = 33 if wide == "local run length" else 2
    if kernel == "probe_classify":
        t_in = _bool_patch(_both(_probe_inputs(base, 8, rl))[1], 6)
    else:
        t_in = _bool_patch(_both(_commit_inputs(base, 8, rl))[1], 11)
    with pytest.raises(ValueError, match=f"{wide} = (64|33) is above 32"):
        getattr(step_kernels, kernel)(tcfg, *t_in)
