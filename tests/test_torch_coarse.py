"""The port's coarse sharer vector (Dir-G, `sharer_group` > 1) against the
JAX package, on the CPU.

Whole runs: tests/test_coarse.py's machines (8 cores at G = 4 and 32 on
three generators, the 64-core hot-lines machine, local runs, and the
router plus DRAM queue on the coarse directory) through the port's
`Engine(device="cpu")`, the JAX `Engine` with the XLA and the Pallas step,
and the golden model: bit-exact cycles, all 26 counters and every state
field, both epoch planes included. One step from a JAX mid-run coarse
state. Kernels: the port's plain `probe_classify` and `commit_step` at
G > 1 against the Pallas kernels in interpret mode, on random inputs with
epoch mismatches and on a mid-run JAX coarse state; the group-table
reductions against the JAX package's `_group_tables` and against the
Pallas full-map `sharer_reductions` on the groups' member cores. Integer
simulator: every tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import (
    CacheConfig,
    CoreConfig,
    MachineConfig,
    NocConfig,
    small_test_config,
)
from primesim_tpu.kernels.reductions import sharer_reductions as j_reduce
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.engine import _group_tables as j_group_tables
from primesim_tpu.sim.engine import run_chunk as j_run_chunk
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import EV_LD, EV_ST, fold_ins, from_event_lists
from primesim_tpu_torch import convert
from primesim_tpu_torch.kernels import reductions, step_kernels
from primesim_tpu_torch.kernels.step_kernels import CL_JOIN, PL_OTHER_SH, PL_SELF_BIT
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim.state import dirm_width, llc_meta_width

from test_torch_engine import (
    assert_port_matches_everything,
    assert_states_equal,
    jax_arrays,
    port_cfg,
)
from test_torch_kernels import (
    _assert_same,
    _both,
    _check_probe,
    _commit_both,
    _commit_inputs,
    _probe_both,
    _probe_inputs,
    _words,
)


def gcfg(n=8, G=4, **kw):
    """tests/test_coarse.py's small coarse machine."""
    kw.setdefault("n_banks", 4)
    kw.setdefault("quantum", 400)
    return small_test_config(n, sharer_group=G, **kw)


def hot_lines_machine():
    """tests/test_coarse.py's 64-core machine (16 groups of 4) and its
    hot-lines trace."""
    cfg = MachineConfig(
        n_cores=64, n_banks=16,
        l1=CacheConfig(size=1024, ways=2, line=64, latency=2),
        llc=CacheConfig(size=4096, ways=4, line=64, latency=10),
        noc=NocConfig(mesh_x=4, mesh_y=4),
        quantum=500, sharer_group=4,
    )
    rng = np.random.default_rng(7)
    evs = []
    for _ in range(64):
        core = []
        for _ in range(24):
            line = int(rng.integers(0, 12))
            t = EV_ST if rng.random() < 0.4 else EV_LD
            core.append((t, 2, line * 64))
        evs.append(core)
    return cfg, from_event_lists(evs)


def router_machine():
    return small_test_config(
        8, n_banks=8, quantum=500, local_run_len=4, sharer_group=4,
        dram_queue=True, dram_service=40,
        core=CoreConfig(o3_overlap_256=64),
        noc=NocConfig(mesh_x=4, mesh_y=2, contention=True,
                      contention_model="router"),
    )


COARSE_TRACES = {
    "false_sharing": lambda: synth.false_sharing(8, n_mem_ops=40, seed=31),
    "uniform_random": lambda: synth.uniform_random(8, n_mem_ops=50, seed=32),
    "lock_contention": lambda: synth.lock_contention(8, n_critical=8, seed=33),
}


# ------------------------------------------------------------ whole runs


@pytest.mark.parametrize("G", [4, 32])
@pytest.mark.parametrize("gen", sorted(COARSE_TRACES))
def test_parity_coarse(gen, G):
    te = assert_port_matches_everything(gcfg(8, G), COARSE_TRACES[gen](), chunk_steps=50)
    assert te.counters["invalidations"].sum() > 0


def test_parity_coarse_64core_hot_lines():
    # group broadcasts, owner re-recording and back-invalidations
    cfg, tr = hot_lines_machine()
    te = assert_port_matches_everything(cfg, tr, chunk_steps=32)
    assert te.counters["invalidations"].sum() > 0


def test_parity_coarse_with_local_runs():
    tr = fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=35))
    assert_port_matches_everything(gcfg(8, 4, local_run_len=4), tr, chunk_steps=16)


def test_parity_coarse_with_router_and_dram_queue():
    tr = fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=36))
    te = assert_port_matches_everything(router_machine(), tr, chunk_steps=16)
    assert te.counters["noc_contention_cycles"].sum() > 0
    assert te.counters["dram_queue_cycles"].sum() > 0


@pytest.mark.parametrize("G", [1, 4])
def test_the_engine_joins_only_under_a_full_map(G, monkeypatch):
    """The commit's join branch is never taken under G > 1: the engine
    hands commit_step no join lane there, while the same trace on the
    full map does join."""
    joins = []
    real = step_kernels.commit_step

    def spy(cfg, l1, dirm, tag_rows, shw, vic_shw, lanes, *rest):
        joins.append(int((lanes[:, CL_JOIN] != 0).sum()))
        return real(cfg, l1, dirm, tag_rows, shw, vic_shw, lanes, *rest)

    monkeypatch.setattr(step_kernels, "commit_step", spy)
    tr = synth.readers_writer(8, n_rounds=3, seed=47)
    cfg = gcfg(8, G)
    te = t_engine.Engine(port_cfg(cfg), tr, chunk_steps=32, device="cpu")
    te.run()
    assert len(joins) == te.steps_run
    assert (sum(joins) > 0) == (G == 1)


def _jax_mid_run(cfg, tr, steps):
    je = JEngine(dataclasses.replace(cfg, step_impl="pallas"), tr, chunk_steps=steps)
    je.run_steps(steps)
    assert not je.done()
    return je


@pytest.mark.parametrize(
    "machine,steps",
    [("hot_lines", 24), ("router", 8), ("local_runs", 8)],
)
def test_one_step_from_a_jax_mid_run_coarse_state(machine, steps):
    if machine == "hot_lines":
        cfg, tr = hot_lines_machine()
    elif machine == "router":
        cfg = router_machine()
        tr = fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=36))
    else:
        cfg = gcfg(8, 4, local_run_len=4)
        tr = fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=35))
    je = _jax_mid_run(cfg, tr, steps)
    tcfg = port_cfg(cfg)
    tst = convert.state_from_numpy(tcfg, jax_arrays(je.state), "cpu")
    events = torch.from_numpy(tr.line_events(cfg.line_bits))
    j_next = j_run_chunk(je.cfg, 1, je.events, je.state, has_sync=je.has_sync)
    t_next = t_engine.step(tcfg, events, tst, has_sync=je.has_sync)
    assert_states_equal(j_next, t_next, "after one step")


def test_convert_round_trip_at_g4():
    """A JAX coarse state, both epoch planes included, crosses into the
    port and back unchanged."""
    cfg, tr = hot_lines_machine()
    je = _jax_mid_run(cfg, tr, 40)
    arrays = jax_arrays(je.state)
    tst = convert.state_from_numpy(port_cfg(cfg), arrays, "cpu")
    back = convert.state_to_numpy(tst)
    assert set(back) == set(arrays)
    for f, a in arrays.items():
        if isinstance(a, dict):  # the knobs and the fault state
            for k, v in a.items():
                np.testing.assert_array_equal(back[f][k], v, err_msg=f"{f}.{k}")
        else:
            np.testing.assert_array_equal(back[f], a, err_msg=f)
    FS = cfg.l1.ways * cfg.l1.sets
    W2 = cfg.llc.ways
    l1_eph = back["l1"][:, 4 * FS : 5 * FS]
    llc_eph = back["dirm"][:, 3 * W2 : 4 * W2]
    assert l1_eph.any() and llc_eph.any()  # the epochs moved
    np.testing.assert_array_equal(l1_eph, arrays["l1"][:, 4 * FS : 5 * FS])


# ---------------------------------------------------------------- kernels


def _coarse_cfgs(C, G):
    """(JAX, port) configs: tests/test_torch_kernels.py's shapes, coarse."""
    if C == 8:
        j = small_test_config(8, n_banks=4, quantum=300, sharer_group=G)
    else:
        j = dataclasses.replace(hot_lines_machine()[0], sharer_group=G)
    return j, port_cfg(j)


def _epoch_mismatches(cfg, l1, dirm, line):
    """Ways of the accessed set whose validation rests on the group bit
    (live tag, not the owner, group bit set) while the epochs differ."""
    C, S1, W1, W2 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, FS = cfg.n_sharer_words, llc_meta_width(cfg), W1 * S1
    logG = cfg.sharer_group.bit_length() - 1
    rows = np.arange(C)[:, None]
    cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
    tag, st, ptr, eph = (l1[rows, p * FS + cols] for p in (0, 1, 3, 4))
    prow, pway = ptr // W2, ptr % W2
    g = (np.arange(C) >> logG)[:, None]
    word = dirm[prow, MW + pway * NW + (g >> 5)]
    bit = ((word.view(np.uint32) >> (g & 31).astype(np.uint32)) & 1) != 0
    live = (st != 0) & (dirm[prow, 2 * pway] == tag) & (dirm[prow, 2 * pway + 1] != rows)
    return int((live & bit & (dirm[prow, 3 * W2 + pway] != eph)).sum())


def _force_group_copies(cfg, arrs):
    """Make way 0 of cores 0 and 1 an S copy whose validation rests on
    its group bit: core 0's fill-time epoch differs from the entry's (the
    guard must drop it), core 1's equals it (it must stay S)."""
    l1, dirm, slot, line = arrs[:4]
    S1, W2 = cfg.l1.sets, cfg.llc.ways
    NW, MW, FS = cfg.n_sharer_words, llc_meta_width(cfg), cfg.l1.ways * S1
    logG = cfg.sharer_group.bit_length() - 1
    for c, bump in ((0, 1), (1, 0)):
        col = line[c] & (S1 - 1)  # way 0 of the accessed set
        ptr = l1[c, 3 * FS + col]
        r, w = ptr // W2, ptr % W2
        l1[c, col], l1[c, FS + col] = line[c], 1  # tag, S
        g = c >> logG
        dirm[r, 2 * w : 2 * w + 2] = [line[c], -1]  # tag, no owner
        dirm[r, MW + w * NW + (g >> 5)] |= np.int32(1) << (g & 31)
        l1[c, 4 * FS + col] = dirm[r, 3 * W2 + w] + bump


def _mid_run_probe_inputs(cfg, tr, steps):
    """The port's probe arguments from a mid-run JAX coarse state: its L1
    and directory, and each core's event line at its trace pointer."""
    je = _jax_mid_run(cfg, tr, steps)
    C, B, S2 = cfg.n_cores, cfg.n_banks, cfg.llc.sets
    logB = B.bit_length() - 1
    events = tr.line_events(cfg.line_bits)
    ptr = np.minimum(np.asarray(je.state.ptr), events.shape[1] - 1)
    line = events[np.arange(C), ptr, 2].astype(np.int32)
    slot = ((line & (B - 1)) * S2 + ((line >> logB) & (S2 - 1))).astype(np.int32)
    return [
        np.array(je.state.l1), np.array(je.state.dirm), slot, line,
        np.arange(C, dtype=np.int32), np.asarray(je.state.step, np.int32),
    ]


@pytest.mark.parametrize("C,G", [(8, 4), (8, 32), (64, 4), (64, 16)])
@pytest.mark.parametrize("rl", [0, 2])
def test_probe_classify_coarse_matches_pallas(C, G, rl):
    """Random inputs: epochs 0-2 in the L1 plane and the directory, so
    many group-bit copies meet a changed epoch."""
    jcfg, tcfg = _coarse_cfgs(C, G)
    arrs = _probe_inputs(jcfg, 500 + C + G + rl, rl)
    _force_group_copies(jcfg, arrs)
    assert _epoch_mismatches(jcfg, *arrs[:2], arrs[3]) > 0
    j_out, t_out, mrows = _probe_both(jcfg, tcfg, arrs)
    lanes = _check_probe(jcfg, j_out, t_out, mrows)
    weff = t_out[2].numpy()
    if rl == 0:  # (a run patch may rewrite these ways' states)
        assert weff[0, 0] == 0 and weff[1, 0] == 1  # I by the guard, S
    assert lanes[:, PL_SELF_BIT].any()
    # any set bit shares under Dir-G, the core's own group bit included
    assert (lanes[:, PL_OTHER_SH] != 0).sum() >= (lanes[:, PL_SELF_BIT] != 0).sum()


def test_probe_classify_coarse_on_a_mid_run_jax_state():
    cfg, tr = hot_lines_machine()
    arrs = _mid_run_probe_inputs(cfg, tr, 40)
    tcfg = port_cfg(cfg)
    lanes = _check_probe(cfg, *_probe_both(cfg, tcfg, arrs))
    assert lanes[:, step_kernels.PL_HIT_ANY].any()
    assert lanes[:, PL_OTHER_SH].any()


@pytest.mark.parametrize("C,G", [(8, 4), (64, 4), (64, 16)])
@pytest.mark.parametrize("rl", [0, 2])
def test_commit_step_coarse_matches_pallas(C, G, rl):
    """Group self and owner words in the winners' and joiners' deltas
    (joins never reach the commit under G > 1 in the engine, see
    test_the_engine_joins_only_under_a_full_map; the function is held
    to the Pallas kernel on them all the same)."""
    jcfg, tcfg = _coarse_cfgs(C, G)
    arrs = _commit_inputs(jcfg, 700 + C + G + rl, rl)
    j_out, t_out = _commit_both(jcfg, tcfg, arrs)
    _assert_same(j_out, t_out, ["l1", "dirm", "counters"])
    assert (t_out[1].numpy() != arrs[1]).any()


@pytest.mark.parametrize(
    "n,G,mx,my",
    [(8, 4, 2, 2), (40, 16, 4, 4), (64, 4, 4, 4), (1024, 64, 32, 32),
     (2048, 64, 16, 16)],
)
def test_group_tables_match_jax(n, G, mx, my):
    """The port's tables equal the JAX package's: a partial last group
    (40 cores, G = 16), cores on more tiles than the mesh has (2048 on
    256) and rung 5's group width."""
    cfg = MachineConfig(
        n_cores=n, n_banks=16, noc=NocConfig(mesh_x=mx, mesh_y=my),
        sharer_group=G,
    )
    for a, b in zip(t_engine._group_tables(port_cfg(cfg)), j_group_tables(cfg)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _expand_groups(words, n_cores, G):
    """Group-bit words [C, NWg] -> the member cores' bit words
    [C, ceil(n_cores/32)]: core t is set iff its group's bit is."""
    C = words.shape[0]
    gbits = ((words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    gbits = gbits.reshape(C, -1)
    tbits = gbits[:, np.arange(n_cores) // G].astype(np.uint64)
    pad = (-n_cores) % 32
    tbits = np.concatenate([tbits, np.zeros((C, pad), np.uint64)], 1)
    w = (tbits.reshape(C, -1, 32) << np.arange(32, dtype=np.uint64)).sum(2)
    return w.astype(np.uint32).view(np.int32)


GROUP_CASES = ["random", "mid_run", "self_group", "owner_outside", "owner_inside"]


@pytest.mark.parametrize(
    "n,G,case",
    [(64, 4, c) for c in GROUP_CASES]  # the mid-run state is this machine's
    + [(40, 16, c) for c in GROUP_CASES if c != "mid_run"],  # a partial group
)
def test_group_reductions_match_the_full_map_kernel_on_members(n, G, case):
    """The coarse reductions over group bits equal the JAX package's
    Pallas full-map `sharer_reductions` over every member core of the set
    groups: counts and hops with the requester excluded (the Pallas
    kernel skips the self bit), the victim's members plus an owner
    outside its groups counted once, and the latency over every member
    of the flagged groups, the requester's included (the Pallas kernel
    with no core excluded, cid = -1)."""
    noc = NocConfig(mesh_x=4, mesh_y=4 if n == 64 else 2)
    jcfg = MachineConfig(n_cores=n, n_banks=16, noc=noc, sharer_group=G)
    jfull = dataclasses.replace(jcfg, sharer_group=1)
    tcfg = port_cfg(jcfg)
    rng = np.random.default_rng(900 + n + G + GROUP_CASES.index(case))
    NW = jcfg.n_sharer_words
    logG = G.bit_length() - 1
    cid = np.arange(n, dtype=np.int32)
    if case == "mid_run":
        cfg, tr = hot_lines_machine()
        pc = step_kernels.probe_classify(
            port_cfg(cfg), *_both(_mid_run_probe_inputs(cfg, tr, 40))[1]
        )
        shw, vic_shw = pc[3].numpy(), pc[4].numpy()
        vic_owner = pc[5][:, step_kernels.PL_VIC_OWNER].numpy()
    else:
        # sparse group words, a third of the rows with every group set
        shw = _words(rng, (n, NW)) & _words(rng, (n, NW))
        vic_shw = _words(rng, (n, NW)) & _words(rng, (n, NW))
        full = rng.random(n) < 0.3
        shw[full] = vic_shw[full] = -1
        vic_owner = rng.integers(-1, n, n).astype(np.int32)
    one = np.int32(1)
    gs = cid >> logG
    if case == "self_group":
        shw[cid, gs >> 5] |= (one << (gs & 31)).astype(np.uint32).view(np.int32)
    if case == "owner_outside":
        vic_owner = rng.integers(0, n, n).astype(np.int32)
        og = vic_owner >> logG
        vic_shw[cid, og >> 5] &= ~(one << (og & 31)).astype(np.uint32).view(np.int32)
    elif case == "owner_inside":
        vic_owner = rng.integers(0, n, n).astype(np.int32)
        og = vic_owner >> logG
        vic_shw[cid, og >> 5] |= (one << (og & 31)).astype(np.uint32).view(np.int32)
    inv_row, vic_valid = rng.random(n) < 0.6, rng.random(n) < 0.6
    btile = rng.integers(0, jcfg.n_tiles, n).astype(np.int32)
    link, router = np.asarray(3, np.int32), np.asarray(2, np.int32)
    tables = tuple(torch.from_numpy(a) for a in t_engine._group_tables(tcfg))
    got = reductions.sharer_reductions(
        tcfg, *_both([shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid,
                      link, router])[1], tables,
    )
    m_shw = _expand_groups(shw, n, G)
    m_vic = _expand_groups(vic_shw, n, G)
    args = [m_shw, m_vic, btile, vic_owner, inv_row, vic_valid]
    want = j_reduce(jfull, *args, cid, link, router)
    want_lat = j_reduce(jfull, *args, np.full(n, -1, np.int32), link, router)[0]
    _assert_same(
        [want_lat, *want[1:]], got,
        ["inv_lat", "inv_cnt", "inv_hops", "back_cnt", "back_hops"],
    )
    assert got[1].numpy().max() > 0
    if case != "mid_run":  # (the mid-run victims hold no sharers)
        assert got[3].numpy().max() > 0
    if case == "self_group":  # the requester counts in the latency only
        assert (got[1].numpy()[inv_row] % G == G - 1).any()


def test_group_reductions_need_the_tables():
    jcfg, tcfg = _coarse_cfgs(8, 4)
    rng = np.random.default_rng(5)
    args = _both([
        _words(rng, (8, 1)), _words(rng, (8, 1)), np.zeros(8, np.int32),
        np.zeros(8, np.int32), np.ones(8, bool), np.ones(8, bool),
        np.arange(8, dtype=np.int32), np.asarray(1, np.int32), np.asarray(1, np.int32),
    ])[1]
    with pytest.raises(ValueError, match="group tables"):
        reductions.sharer_reductions(tcfg, *args)


def test_rung5_shapes_in_the_group_tables():
    """configs/rung5_16384core_wafer.json: 256 groups of 64 in 8 words,
    and tables of [16384 tiles, 256 groups], as the card's kernel takes
    them; the JAX package builds the same tables (test above, smaller)."""
    import json
    import os

    from primesim_tpu_torch.config.machine import MachineConfig as TCfg

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "rung5_16384core_wafer.json")) as f:
        cfg = TCfg.from_dict(json.load(f))
    assert (cfg.n_sharer_groups, cfg.n_sharer_words, cfg.n_tiles) == (256, 8, 16384)
    assert dirm_width(cfg) == llc_meta_width(cfg) + cfg.llc.ways * 8 == 192
