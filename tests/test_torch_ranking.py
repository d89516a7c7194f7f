"""The port's sort-based FIFO ranking (`primesim_tpu_torch/ops/ranking.py`)
against the JAX package's (`primesim_tpu/ops/ranking.py`), on the kinds
of input tests/test_ranking.py holds the JAX one to: duplicate keys,
masked lanes and slots, real concatenated mesh routes as the router
block builds them, and both methods. Every input is made with numpy from
a seed; the comparison is exact over the whole output, masked slots
included (their garbage is a deterministic function of the inputs in
both packages), and over the valid slots against the one-hot-matmul
oracle of tests/test_ranking.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import NocConfig, small_test_config
from primesim_tpu.noc.mesh import n_links as j_n_links
from primesim_tpu.noc.mesh import path_links as j_path_links
from primesim_tpu.ops.ranking import lane_order as j_lane_order
from primesim_tpu.ops.ranking import segmented_rank as j_rank
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.noc import mesh as t_mesh
from primesim_tpu_torch.noc import topology as t_topology
from primesim_tpu_torch.ops.ranking import lane_order, segmented_rank

from test_ranking import _unique_segs, matmul_oracle


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _both_ranks(seg, key, n_seg, method):
    want = np.asarray(
        j_rank(jnp.asarray(seg), jnp.asarray(key), n_seg, method=method)
    )
    got = segmented_rank(_t(seg), _t(key), n_seg, method=method)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_order_matches_jax_with_duplicates(seed):
    rng = np.random.default_rng(seed)
    for C, hi in ((1, 5), (7, 3), (100, 30), (1024, 200)):
        key = rng.integers(-hi, hi, C).astype(np.int32)
        want = np.asarray(j_lane_order(jnp.asarray(key)))
        got = lane_order(_t(key))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_lane_order_extreme_keys():
    key = np.array([2**31 - 1, -(2**31), 0, 2**31 - 1, -(2**31), 5], np.int32)
    np.testing.assert_array_equal(
        lane_order(_t(key)).numpy(), np.asarray(j_lane_order(jnp.asarray(key)))
    )


@pytest.mark.parametrize("method", ["packed", "lex"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_segments_match_jax_and_the_oracle(method, seed):
    rng = np.random.default_rng(seed)
    C, S, n_seg = 64, 9, 37
    seg = _unique_segs(rng, C, S, n_seg)
    key = rng.integers(0, 500, C).astype(np.int32)  # dense: duplicates
    got = _both_ranks(seg, key, n_seg, method)
    valid = seg < n_seg
    np.testing.assert_array_equal(got[valid], matmul_oracle(seg, key, n_seg)[valid])


@pytest.mark.parametrize("method", ["packed", "lex"])
def test_all_keys_tied_rank_zero(method):
    rng = np.random.default_rng(7)
    seg = _unique_segs(rng, 16, 4, 8, mask_p=0.0)
    got = _both_ranks(seg, np.full(16, 42, np.int32), 8, method)
    np.testing.assert_array_equal(got, 0)


@pytest.mark.parametrize("method", ["packed", "lex"])
def test_masked_lanes_neither_rank_nor_compete(method):
    rng = np.random.default_rng(11)
    C, S, n_seg = 32, 5, 19
    seg = _unique_segs(rng, C, S, n_seg, mask_p=0.2)
    key = rng.integers(0, 10_000, C).astype(np.int32)
    competing = rng.random(C) < 0.6
    seg = np.where(competing[:, None], seg, n_seg).astype(np.int32)
    got = _both_ranks(seg, key, n_seg, method)
    valid = seg < n_seg
    want = matmul_oracle(seg, key, n_seg, competitor=competing)
    np.testing.assert_array_equal(got[valid], want[valid])


@pytest.mark.parametrize("method", ["packed", "lex"])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 4), (3, 2), (8, 8)])
def test_engine_shaped_mesh_routes(mesh, method):
    """Concatenated request/reply/arrival legs over the port's own routes,
    which equal the JAX package's link for link, keyed as the engine keys
    its lanes (clock * C + core id)."""
    mx, my = mesh
    jcfg = small_test_config(
        mx * my * 2, n_banks=8,
        noc=NocConfig(mesh_x=mx, mesh_y=my, link_lat=1, router_lat=1),
    )
    tcfg = TCfg.from_json(jcfg.to_json())
    C, NL = jcfg.n_cores, j_n_links(jcfg)
    assert t_mesh.n_links(tcfg) == NL
    rng = np.random.default_rng(mx * 10 + my)
    ctile = (np.arange(C) % jcfg.n_tiles).astype(np.int32)
    btile = rng.integers(0, jcfg.n_tiles, C).astype(np.int32)
    htile = rng.integers(0, jcfg.n_tiles, C).astype(np.int32)
    paths = []
    for a, b in ((ctile, btile), (btile, ctile), (ctile, htile)):
        want = np.asarray(j_path_links(jcfg, jnp.asarray(a), jnp.asarray(b)))
        got = t_topology.path_links(tcfg, _t(a), _t(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        paths.append(got)
    txn = rng.random(C) < 0.6
    bar = ~txn & (rng.random(C) < 0.5)
    pth, mask = t_mesh.concat_legs(
        [(paths[0], torch.from_numpy(txn)), (paths[1], torch.from_numpy(txn)),
         (paths[2], torch.from_numpy(bar))]
    )
    ok = (mask & (pth >= 0)).numpy()
    seg = np.where(ok, pth.numpy(), NL).astype(np.int32)
    key = (rng.integers(0, 50, C) * C + np.arange(C)).astype(np.int32)
    got = _both_ranks(seg, key, NL, method)
    want = matmul_oracle(seg, key, NL, competitor=txn | bar)
    np.testing.assert_array_equal(got[ok], want[ok])


def test_precomputed_order_and_auto_method():
    rng = np.random.default_rng(9)
    C, n_seg = 32, 12
    key = rng.integers(0, 100, C).astype(np.int32)
    seg = _unique_segs(rng, C, 4, n_seg)
    a = segmented_rank(_t(seg), _t(key), n_seg)
    b = segmented_rank(_t(seg), n_seg=n_seg, order=lane_order(_t(key)))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(j_rank(jnp.asarray(seg), jnp.asarray(key), n_seg))
    )


def test_lex_is_taken_past_the_packing_guard():
    """(n_seg + 1) * C above int32: "auto" must take the two-key sort, and
    it must still equal JAX's."""
    rng = np.random.default_rng(17)
    C, n_seg = 16, 2**28  # (n_seg + 1) * 16 > 2^31 - 1
    seg = rng.choice(n_seg, size=(C, 3)).astype(np.int32)
    seg[:, 1] = seg[:, 0] ^ 1  # distinct within a lane, shared across lanes
    seg[rng.random((C, 3)) < 0.3] = n_seg
    seg[::4, 0] = 5  # a crowded segment
    key = rng.integers(0, 6, C).astype(np.int32)
    got = _both_ranks(seg, key, n_seg, "auto")
    np.testing.assert_array_equal(
        got, segmented_rank(_t(seg), _t(key), n_seg, method="lex").numpy()
    )
    valid = seg < n_seg
    assert got[valid].max() > 0
    with pytest.raises(ValueError, match="unknown method"):
        segmented_rank(_t(seg), _t(key), n_seg, method="matmul")


def test_packed_and_lex_agree_on_engine_scale():
    rng = np.random.default_rng(17)
    C, S, n_seg = 128, 12, 257
    seg = _unique_segs(rng, C, S, n_seg)
    key = rng.integers(0, 1 << 20, C).astype(np.int32)
    a = _both_ranks(seg, key, n_seg, "packed")
    b = _both_ranks(seg, key, n_seg, "lex")
    valid = seg < n_seg
    np.testing.assert_array_equal(a[valid], b[valid])
