"""The port's kernels against the JAX package's Pallas kernels.

Each Pallas kernel runs as the JAX package's own tests run it on the CPU
(interpret mode); the port's plain versions, which the CUDA kernels are
held against on the card (chip_smoke.py), take the same inputs made from
a numpy seed. Integer simulator, so every comparison is exact: the
tolerance is 0. Shapes: 8 cores (one sharer word) and 64 cores (two
words, crossing the word boundary), local-run lengths 0, 2 and 8, with
sharer words that use bit 31 and with tied tags and LRU stamps.
"""

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
from primesim_tpu_torch.sim.state import dirm_width, llc_meta_width


def _cfgs(C):
    if C == 8:
        j = JCfg(
            n_cores=8, n_banks=4,
            l1=JCache(1024, 2, 64, 2), llc=JCache(4096, 4, 64, 10),
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


def _both(arrs):
    """(jax-side numpy arrays, port torch tensors) of the same inputs."""
    return arrs, [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_same(j_out, t_out, names):
    assert len(j_out) == len(t_out) == len(names)
    for n, a, b in zip(names, j_out, t_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=n)


def _probe_inputs(cfg, seed, rl):
    rng = np.random.default_rng(seed)
    C, S1, W1, W2 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, MW, DW = cfg.n_sharer_words, llc_meta_width(cfg), dirm_width(cfg)
    FS = W1 * S1
    n_lines = 6  # few lines: tags tie across ways and hit often
    l1 = np.concatenate(
        [
            rng.integers(-1, n_lines, (C, FS)),  # tags
            rng.integers(0, 4, (C, FS)),  # MESI
            rng.integers(0, 4, (C, FS)),  # LRU stamps, many ties
            rng.integers(0, cfg.n_banks * cfg.llc.sets * W2, (C, FS)),  # ptr
            rng.integers(0, 3, (C, FS)),  # epoch
        ],
        axis=1,
    ).astype(np.int32)

    def dir_rows(n):
        r = np.zeros((n, DW), np.int32)
        r[:, 0 : 2 * W2 : 2] = rng.integers(-1, n_lines, (n, W2))
        r[:, 1 : 2 * W2 : 2] = rng.integers(-1, C, (n, W2))
        r[:, 2 * W2 : 3 * W2] = rng.integers(0, 3, (n, W2))
        r[:, 3 * W2 : 4 * W2] = rng.integers(0, 3, (n, W2))
        r[:, MW:] = _words(rng, (n, W2 * NW))
        return r

    vrows = dir_rows(C * W1).reshape(C, W1 * DW)
    mrows = dir_rows(C)
    line = rng.integers(0, n_lines, C).astype(np.int32)
    cid = np.arange(C, dtype=np.int32)
    # pointer validation must see the core itself as owner now and then
    # half the ways' pointers name an entry whose tag matches (a live
    # copy), and a third of the entries name the core itself as owner
    vr = vrows.reshape(C, W1, DW)
    w1cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
    cc, ww = np.nonzero(rng.random((C, W1)) < 0.5)
    pway = l1[cc, 3 * FS + w1cols[cc, ww]] % W2
    vr[cc, ww, 2 * pway] = l1[cc, w1cols[cc, ww]]
    own = vr[:, :, 1 : 2 * W2 : 2]  # a view
    pick = rng.random(own.shape) < 0.3
    own[pick] = np.broadcast_to(cid[:, None, None], own.shape)[pick]
    step = np.asarray(rng.integers(0, 1000), np.int32)
    arrs = [l1, vrows, mrows, line, cid, step]
    if rl:
        arrs += [
            rng.integers(0, 2, (C, rl)).astype(np.int32),
            rng.integers(0, 2, (C, rl)).astype(np.int32),
            # run columns, half of them inside the accessed set
            np.where(
                rng.random((C, rl)) < 0.5,
                rng.integers(0, W1, (C, rl)) * S1 + (line & (S1 - 1))[:, None],
                rng.integers(0, FS, (C, rl)),
            ).astype(np.int32),
        ]
    return arrs


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 2, 8])
def test_probe_classify_matches_pallas(C, rl):
    jcfg, tcfg = _cfgs(C)
    j_in, t_in = _both(_probe_inputs(jcfg, 100 + C + rl, rl))
    j_out = j_probe(jcfg, *j_in)
    t_out = step_kernels.probe_classify(tcfg, *t_in)  # CPU: the plain version
    _assert_same(j_out, t_out, ["tag", "lru", "weff", "shw", "vic_shw", "lanes"])
    lanes = t_out[5].numpy()
    # the inputs reach every classification branch
    assert lanes[:, step_kernels.PL_HIT_ANY].any()
    assert not lanes[:, step_kernels.PL_HIT_ANY].all()
    assert lanes[:, step_kernels.PL_LLC_HAS].any()
    assert lanes[:, step_kernels.PL_SELF_BIT].any()


def _commit_inputs(cfg, seed, rl):
    rng = np.random.default_rng(seed)
    C, S1, W1, W2 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways, cfg.llc.ways
    NW, DW = cfg.n_sharer_words, dirm_width(cfg)
    FS = W1 * S1
    n_lines = 6
    l1 = rng.integers(-5, 50, (C, 5 * FS)).astype(np.int32)
    # the full int32 range: row deltas and counter folds must wrap
    mrows = rng.integers(-(2**31), 2**31, (C, DW), dtype=np.int64).astype(np.int32)
    tag_rows = rng.integers(-1, n_lines, (C, W1)).astype(np.int32)
    shw = _words(rng, (C, NW))
    flags = rng.integers(0, 2, (C, 18))
    lanes = np.stack(
        [
            rng.integers(0, n_lines, C),  # line
            rng.integers(0, W1, C),  # hit_way
            rng.integers(0, W1, C),  # l1_vway
            flags[:, 3], flags[:, 4], flags[:, 5], flags[:, 6], flags[:, 7],
            flags[:, 8],
            rng.integers(0, 4, C),  # st_val
            rng.integers(0, cfg.n_banks * cfg.llc.sets, C),  # slot
            rng.integers(0, W2, C),  # llc_hway
            rng.integers(0, W2, C),  # llc_vway
            flags[:, 13], flags[:, 14], flags[:, 15], flags[:, 16],
            rng.integers(0, C, C),  # oclamp
        ],
        axis=1,
    ).astype(np.int32)
    cid = np.arange(C, dtype=np.int32)
    step = np.asarray(rng.integers(0, 1000), np.int32)
    counters = rng.integers(-(2**31), 2**31, (26, C), dtype=np.int64).astype(np.int32)
    delta = rng.integers(0, 2**30, (26, C)).astype(np.int32)
    arrs = [l1, mrows, tag_rows, shw, lanes, cid, step, counters, delta]
    if rl:
        line = lanes[:, 0]
        arrs += [
            rng.integers(0, 2, (C, rl)).astype(np.int32),
            rng.integers(0, 2, (C, rl)).astype(np.int32),
            np.where(
                rng.random((C, rl)) < 0.5,
                rng.integers(0, W1, (C, rl)) * S1 + (line & (S1 - 1))[:, None],
                rng.integers(0, FS, (C, rl)),
            ).astype(np.int32),
        ]
    return arrs


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 2, 8])
def test_commit_step_matches_pallas(C, rl):
    jcfg, tcfg = _cfgs(C)
    j_in, t_in = _both(_commit_inputs(jcfg, 200 + C + rl, rl))
    j_out = j_commit(jcfg, *j_in)
    t_out = step_kernels.commit_step(tcfg, *t_in)
    _assert_same(j_out, t_out, ["l1", "delta_row", "counters"])
    # the folded counters wrapped somewhere, as int32 must
    assert (t_out[2].numpy() < t_in[7].numpy()).any()


@pytest.mark.parametrize("C", [8, 64])
def test_sharer_reductions_matches_pallas(C):
    jcfg, tcfg = _cfgs(C)
    rng = np.random.default_rng(300 + C)
    NW = jcfg.n_sharer_words
    arrs = [
        _words(rng, (C, NW)),
        _words(rng, (C, NW)),
        rng.integers(0, jcfg.n_tiles, C).astype(np.int32),  # btile
        rng.integers(-1, C, C).astype(np.int32),  # vic_owner
        rng.integers(0, 2, C).astype(np.int32),  # inv_row
        rng.integers(0, 2, C).astype(np.int32),  # vic_valid
        np.arange(C, dtype=np.int32),
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
    step_kernels.probe_classify(tcfg, *_both(_probe_inputs(jcfg, 11, 2))[1])
    step_kernels.commit_step(tcfg, *_both(_commit_inputs(jcfg, 12, 2))[1])
    assert build.LAUNCHES == before


def test_wrappers_raise_on_a_device_without_kernels():
    jcfg, tcfg = _cfgs(8)
    t_in = [
        t.to("meta")
        for t in _both(_probe_inputs(jcfg, 7, 0))[1]
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        step_kernels.probe_classify(tcfg, *t_in)
