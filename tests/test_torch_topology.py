"""The port's NoC topologies (mesh, torus, ring) against the JAX package,
on the CPU.

Geometry: the port's `coord_hops`, `hops`, `path_width`, `route_links` and
`path_links` against the JAX package's `noc/topology.py`, for every pair
of tiles on 4x4, 5x3 and 6x4 grids and on 2000 seeded pairs of the IPU
profile's 32x46 torus (even sizes: ties at half a ring on both axes).
Kernel: the plain `sharer_reductions` in its torus and ring modes (full
map, and the group mode's tables) against the JAX Pallas kernel in
interpret mode and the JAX engine's `_group_tables`. Integer simulator:
every tolerance is 0.
"""

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import MachineConfig as JCfg
from primesim_tpu.config.machine import NocConfig as JNoc
from primesim_tpu.config.machine import small_test_config
from primesim_tpu.kernels.reductions import sharer_reductions as j_reduce
from primesim_tpu.noc import topology as j_topo
from primesim_tpu.sim.engine import _group_tables as j_group_tables
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.kernels import reductions
from primesim_tpu_torch.noc import topology as t_topo
from primesim_tpu_torch.sim import engine as t_engine

from test_torch_kernels import _assert_same, _both, _words

TOPOLOGIES = ("mesh", "torus", "ring")
GRIDS = ((4, 4), (5, 3), (6, 4))


def _cfgs(topology, mx, my, n_cores=None, **kw):
    j = small_test_config(
        n_cores or mx * my, n_banks=4,
        noc=JNoc(mesh_x=mx, mesh_y=my, link_lat=3, router_lat=2, topology=topology),
        **kw,
    )
    return j, TCfg.from_json(j.to_json())


def _pairs(n_tiles, n=None, seed=0):
    if n is None:  # every ordered pair
        t = np.arange(n_tiles, dtype=np.int32)
        return np.repeat(t, n_tiles), np.tile(t, n_tiles)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_tiles, n).astype(np.int32),
            rng.integers(0, n_tiles, n).astype(np.int32))


def _check_geometry(jcfg, tcfg, a, b):
    mx, my = jcfg.noc.mesh_x, jcfg.noc.mesh_y
    topo = jcfg.noc.topology
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert t_topo.path_width(tcfg) == j_topo.path_width(jcfg)
    want = np.asarray(j_topo.path_links(jcfg, a, b))
    got = t_topo.path_links(tcfg, ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want, err_msg="path_links")
    j_h = np.asarray(j_topo.hops(jcfg, a, b, xp=np))
    np.testing.assert_array_equal(t_topo.hops(tcfg, ta, tb).numpy(), j_h, err_msg="hops")
    np.testing.assert_array_equal(t_topo.hops(tcfg, a, b), j_h, err_msg="hops (numpy)")
    np.testing.assert_array_equal(
        t_topo.coord_hops(topo, a % mx, a // mx, b % mx, b // mx, mx, my),
        j_topo.coord_hops(topo, a % mx, a // mx, b % mx, b // mx, mx, my, xp=np),
        err_msg="coord_hops",
    )
    for i in range(a.size):
        ref = j_topo.route_links(jcfg, int(a[i]), int(b[i]))
        assert t_topo.route_links(tcfg, int(a[i]), int(b[i])) == ref
        assert tuple(int(x) for x in want[i] if x >= 0) == ref
        assert int(t_topo.hops(tcfg, int(a[i]), int(b[i]))) == len(ref)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("mx,my", GRIDS)
def test_geometry_matches_jax_all_pairs(topology, mx, my):
    jcfg, tcfg = _cfgs(topology, mx, my)
    _check_geometry(jcfg, tcfg, *_pairs(jcfg.n_tiles))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_geometry_matches_jax_on_the_ipu_grid(topology):
    """2000 seeded pairs on the IPU profile's 32x46 grid: the torus's
    routes reach its diameter of 16 + 23 = 39 hops, ties at 16 and 23
    break positive."""
    jcfg, tcfg = _cfgs(topology, 32, 46, n_cores=1472)
    a, b = _pairs(jcfg.n_tiles, 2000, seed=46)
    _check_geometry(jcfg, tcfg, a, b)
    if topology == "torus":
        assert t_topo.path_width(tcfg) == 39
        dx = np.abs(a % 32 - b % 32)
        ties = dx == 16
        assert ties.any()
        links = t_topo.path_links(tcfg, torch.from_numpy(a[ties]), torch.from_numpy(b[ties]))
        assert (links[:, 0].numpy() % 4 == 0).all()  # the first hop goes east (+x)


def _reduce_inputs(jcfg, seed):
    C, NW = jcfg.n_cores, jcfg.n_sharer_words
    rng = np.random.default_rng(seed)
    shw, vic_shw = _words(rng, (C, NW)), _words(rng, (C, NW))
    cid = np.arange(C)
    shw[::3, 0] |= np.int32(-(2**31))  # bit 31
    selfs = cid[1::4]
    shw[selfs, selfs // 32] |= (1 << (selfs % 32)).astype(np.uint32).view(np.int32)
    return [
        shw, vic_shw, rng.integers(0, jcfg.n_tiles, C).astype(np.int32),
        rng.integers(-1, C, C).astype(np.int32), rng.random(C) < 0.6,
        rng.random(C) < 0.6, cid.astype(np.int32), np.asarray(3, np.int32),
        np.asarray(2, np.int32),
    ]


@pytest.mark.parametrize("topology", ["torus", "ring"])
@pytest.mark.parametrize("C,mx,my", [(16, 4, 4), (40, 5, 3), (64, 6, 4)])
def test_sharer_reductions_plain_matches_pallas(topology, C, mx, my):
    """The full-map reductions under the torus and ring hop counts: odd
    grids, more cores than tiles (40 cores on 15 tiles: padding bits and
    tiles shared by cores) and two words (64 cores)."""
    jcfg, tcfg = _cfgs(topology, mx, my, n_cores=C)
    j_in, t_in = _both(_reduce_inputs(jcfg, 70 + C))
    j_out = j_reduce(jcfg, *j_in)
    t_out = reductions.sharer_reductions(tcfg, *t_in)
    _assert_same(j_out, t_out, ["inv_lat", "inv_cnt", "inv_hops", "back_cnt", "back_hops"])
    assert t_out[2].numpy().max() > 0 and t_out[4].numpy().max() > 0
    # the topology's hop count is not the mesh's on these inputs
    mesh = TCfg.from_json(small_test_config(
        C, n_banks=4, noc=JNoc(mesh_x=mx, mesh_y=my, link_lat=3, router_lat=2),
    ).to_json())
    m_out = reductions.sharer_reductions(mesh, *_both(_reduce_inputs(jcfg, 70 + C))[1])
    assert not torch.equal(m_out[2], t_out[2])


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_group_tables_follow_the_topology(topology):
    """The coarse vector's per-(home tile, group) tables against the JAX
    engine's, and its reductions against the JAX engine's group branch
    through a whole run (tests/test_torch_zoo.py); here the tables."""
    j = JCfg.from_json(small_test_config(
        64, n_banks=16, sharer_group=4,
        noc=JNoc(mesh_x=6, mesh_y=4, topology=topology),
    ).to_json())
    t = TCfg.from_json(j.to_json())
    for got, want in zip(t_engine._group_tables(t), j_group_tables(j)):
        np.testing.assert_array_equal(got, want)
