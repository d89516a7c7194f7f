"""The hop-by-hop router in the port against the JAX package, on the CPU.

The kernel: `router_cascade_plain`, which the CUDA kernel is held to on
the card (chip_smoke.py), against the JAX engine's composition around the
Pallas `router_cascade` in interpret mode (the `link_free`/`base`
gathers, the cascade, the departures' drop-scatter-max), on numpy-seeded
inputs at the route widths of 2x2, 4x4 and 32x32 meshes (H = 2, 6 and
62), with and without the barrier-arrival leg: -1-padded routes, masked
hops with pth >= 0, many lanes on one link and link clocks down at the
rebase clamp.

Whole runs: the port's `Engine(device="cpu")` against the JAX `Engine`
(XLA and Pallas steps) and the golden model on the router machines and
traces of tests/test_router.py and tests/test_router_pallas.py. Every
comparison is exact: cycles, all 26 counters and every state field,
`link_free` included.
"""

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
from primesim_tpu.golden.sim import GoldenSim
from primesim_tpu.kernels.router_kernels import SENT as J_SENT
from primesim_tpu.kernels.router_kernels import router_cascade as j_cascade
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import EV_LD, EV_ST, from_event_lists
from primesim_tpu_torch.kernels import build, router_kernels
from primesim_tpu_torch.sim import engine as t_engine

from test_step_pallas import GENERATOR_TRACES
from test_torch_engine import assert_port_matches_everything, port_cfg, port_trace


def _cascade_inputs(C, mesh, has_sync, seed):
    """(link_free, base, pth_all, ok_all, r_all, t0, service, req_hops,
    rep_hops, arr_hops) for a mesh of `mesh` tiles: routes of random
    lengths, -1-padded, a third of their hops on four hot links (many
    lanes cross one link), lane masks per leg (so masked hops with
    pth >= 0), link clocks at the rebase clamp and live, and base from
    real arrivals or the empty-link INT32_MAX."""
    rng = np.random.default_rng(seed)
    legs = 3 if has_sync else 2
    H = max(1, (mesh[0] - 1) + (mesh[1] - 1))
    NL = 4 * mesh[0] * mesh[1]
    link_free = np.where(
        rng.random(NL) < 0.3,
        -(1 << 30) + rng.integers(0, 50, NL),
        rng.integers(-2000, 5000, NL),
    )
    base = np.where(rng.random(NL) < 0.2, 2**31 - 1, rng.integers(-500, 5000, NL))
    hot = rng.choice(NL, 4, replace=False)
    n = rng.integers(0, H + 1, (C, legs))  # route length of each leg
    k = np.arange(H)[None, None, :]
    pth = np.where(
        rng.random((C, legs, H)) < 0.33,
        hot[rng.integers(0, 4, (C, legs, H))],
        rng.integers(0, NL, (C, legs, H)),
    )
    pth = np.where(k < n[:, :, None], pth, -1).reshape(C, legs * H)
    mask = np.repeat(rng.random((C, legs)) < 0.6, H, axis=1)
    ok = mask & (pth >= 0)
    r = rng.integers(0, 40, (C, legs * H))
    lanes = [
        rng.integers(-1000, 5000, C),  # t0
        rng.integers(1, 400, C),  # service
        *(n[:, i] if i < legs else n[:, 0] for i in range(3)),  # hops
    ]
    i32 = [a.astype(np.int32) for a in (link_free, base, pth)]
    return i32 + [ok, r.astype(np.int32)] + [a.astype(np.int32) for a in lanes]


def _cascade_both(arrs, L, R, has_sync):
    """The JAX engine's composition around the Pallas kernel (gathers at
    pc, the cascade, `.at[tgt].max(departs, mode="drop")`) and the port's
    fused router_cascade on the same inputs: ((t_rep_end, t_arr_end,
    link_free'), the same from the port)."""
    import jax.numpy as jnp

    link_free, base, pth, ok, r, *lanes = [jnp.asarray(a) for a in arrs]
    pc = jnp.where(pth >= 0, pth, 0)
    t_rep, t_arr, d_all = j_cascade(
        link_free[pc], base[pc], r, ok, *lanes, L, R, has_sync=has_sync
    )
    tgt = jnp.where(ok, pth, link_free.shape[0])
    want = (t_rep, t_arr, link_free.at[tgt].max(d_all, mode="drop"))
    t = [torch.from_numpy(a) for a in arrs]
    out = t[0].clone()
    got = router_kernels.router_cascade(
        *t[:9], t[9] if has_sync else None,
        torch.tensor(L, dtype=torch.int32), torch.tensor(R, dtype=torch.int32),
        out, has_sync=has_sync,
    )
    np.testing.assert_array_equal(t[0].numpy(), arrs[0])  # read only
    return want, (*got, out)


def _assert_cascade_same(want, got, has_sync):
    for n, a, b in zip(("t_rep_end", "t_arr_end", "link_free_out"), want, got):
        if n == "t_arr_end" and not has_sync:
            assert a is None and b is None
            continue
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)


@pytest.mark.parametrize("has_sync", [False, True])
@pytest.mark.parametrize("mesh,C", [((2, 2), 8), ((4, 4), 16), ((32, 32), 64)])
def test_cascade_plain_matches_pallas(mesh, C, has_sync):
    assert router_kernels.SENT == J_SENT
    H = (mesh[0] - 1) + (mesh[1] - 1)
    arrs = _cascade_inputs(C, mesh, has_sync, seed=H * 10 + has_sync)
    ok, pth = arrs[3], arrs[2]
    assert (~ok & (pth >= 0)).any() and (pth < 0).any()
    live = pth[ok]
    assert len(live) > len(np.unique(live))  # duplicate targets
    for L, R in ((1, 1), (3, 2)):
        want, got = _cascade_both(arrs, L, R, has_sync)
        _assert_cascade_same(want, got, has_sync)
        assert (got[2].numpy() != arrs[0]).any()


def test_cascade_wraps_like_jax():
    """Floors, clocks and departures near the int32 limits wrap in both
    packages, and the signed max keeps the wrapped departures."""
    arrs = _cascade_inputs(8, (2, 2), True, seed=5)
    arrs[0][:] = 2**31 - 3  # max(lf, bs) + rank*L wraps past INT32_MAX
    arrs[2][:] = np.random.default_rng(6).integers(0, 16, arrs[2].shape)
    arrs[3][:] = True
    arrs[5][:] = 2**31 - 2  # t0 + R wraps
    want, got = _cascade_both(arrs, 2, 1, True)
    _assert_cascade_same(want, got, True)


def test_cascade_wrapper_checks_its_device_and_counts_nothing_on_cpu():
    arrs = [torch.from_numpy(a) for a in _cascade_inputs(8, (2, 2), False, seed=1)]
    one = torch.tensor(1, dtype=torch.int32)
    before = dict(build.LAUNCHES)
    out = arrs[0].clone()
    router_kernels.router_cascade(*arrs[:9], None, one, one, out, has_sync=False)
    assert build.LAUNCHES == before
    assert "router_cascade" in build.KERNELS
    meta = [a.to("meta") for a in arrs[:9]]
    with pytest.raises(ValueError, match="unsupported device"):
        router_kernels.router_cascade(
            *meta, None, one.to("meta"), one.to("meta"), meta[0].clone(),
            has_sync=False,
        )


def test_cascade_raises_when_the_output_is_link_free():
    """The floors read link_free while departures raise the output, so the
    two must be separate buffers."""
    arrs = [torch.from_numpy(a) for a in _cascade_inputs(8, (2, 2), False, seed=2)]
    one = torch.tensor(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be a copy"):
        router_kernels.router_cascade(
            *arrs[:9], None, one, one, arrs[0], has_sync=False
        )


def test_cascade_raises_above_256_hops():
    """The kernel holds a leg's hops in 8 chunks of 32 lanes; the wrapper
    raises above that on any device, before dispatch."""
    C, H = 2, router_kernels.MAX_HOPS + 1
    z = torch.zeros((C, 2 * H), dtype=torch.int32)
    lane = torch.zeros(C, dtype=torch.int32)
    one = torch.tensor(1, dtype=torch.int32)
    lf = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="257 hops per leg is above 256"):
        router_kernels.router_cascade(
            lf, lf.clone(), z, z != 0, z, lane, lane, lane, lane, None, one,
            one, lf.clone(), has_sync=False,
        )


def rcfg(n=4, mesh_x=2, mesh_y=2, **kw):
    """tests/test_router.py's router machine."""
    return small_test_config(
        n,
        noc=NocConfig(
            mesh_x=mesh_x, mesh_y=mesh_y, link_lat=1, router_lat=1,
            contention=True, contention_model="router",
        ),
        **kw,
    )


ROUTER_TRACES = {
    "false_sharing": lambda: synth.false_sharing(4, n_mem_ops=40, seed=61),
    "uniform_random": lambda: synth.uniform_random(4, n_mem_ops=50, seed=62),
    "lock_contention": lambda: synth.lock_contention(4, n_critical=8, seed=63),
    "barrier_phases": lambda: synth.barrier_phases(4, n_phases=2, seed=64),
}


@pytest.mark.parametrize("gen", sorted(ROUTER_TRACES))
def test_router_runs_match_jax_and_golden(gen):
    te = assert_port_matches_everything(
        rcfg(4, n_banks=4, quantum=300), ROUTER_TRACES[gen](), chunk_steps=50
    )
    assert te.counters["noc_contention_cycles"].sum() > 0


def test_router_16core_hot_path():
    cfg = MachineConfig(
        n_cores=16, n_banks=16,
        l1=CacheConfig(size=1024, ways=2, line=64, latency=2),
        llc=CacheConfig(size=8192, ways=4, line=64, latency=10),
        noc=NocConfig(mesh_x=4, mesh_y=4, contention=True,
                      contention_model="router"),
        quantum=400,
    )
    evs = [[(EV_LD, 4, ((c + i) % 16) * 64) for i in range(8)] for c in range(16)]
    te = assert_port_matches_everything(cfg, from_event_lists(evs), chunk_steps=50)
    assert te.counters["noc_contention_cycles"].sum() > 0


def test_router_local_runs_and_o3():
    cfg = small_test_config(
        8, n_banks=8, quantum=500, local_run_len=4,
        core=CoreConfig(cpi_pattern=(1, 2), o3_overlap_256=64),
        noc=NocConfig(mesh_x=4, mesh_y=2, contention=True,
                      contention_model="router"),
    )
    rng = np.random.default_rng(5)
    evs = []
    for c in range(8):
        core = []
        for i in range(30):
            line = int(rng.integers(0, 24))
            core.append((EV_ST if rng.random() < 0.4 else EV_LD, 2, line * 64))
        evs.append(core)
    assert_port_matches_everything(cfg, from_event_lists(evs), chunk_steps=16)


def _pallas_router_cfg(**kw):
    """tests/test_router_pallas.py's router machine."""
    noc = NocConfig(
        mesh_x=2, mesh_y=2, link_lat=1, router_lat=1,
        contention=True, contention_model="router", contention_lat=2,
    )
    return small_test_config(8, n_banks=4, quantum=400, noc=noc, **kw)


@pytest.mark.parametrize("gen", sorted(GENERATOR_TRACES))
def test_router_every_generator(gen):
    assert_port_matches_everything(
        _pallas_router_cfg(), GENERATOR_TRACES[gen](), chunk_steps=32
    )


def test_router_4x4_mesh_local_runs():
    noc = NocConfig(
        mesh_x=4, mesh_y=4, link_lat=2, router_lat=1,
        contention=True, contention_model="router", contention_lat=3,
    )
    cfg = small_test_config(16, n_banks=16, quantum=500, noc=noc, local_run_len=4)
    tr = synth.fft_like(16, n_phases=2, points_per_core=8, seed=32)
    assert_port_matches_everything(cfg, tr, chunk_steps=32)


@pytest.mark.parametrize("mesh_x,mesh_y", [(2, 2), (4, 1)])
def test_link_clocks_equal_the_golden_absolute_clocks(mesh_x, mesh_y):
    # on the 1x4 mesh both requests cross the eastward link out of tile
    # 1, and core 1 queues one link_lat behind core 0 (test_router.py)
    cfg = rcfg(4, mesh_x=mesh_x, mesh_y=mesh_y, n_banks=4)
    tr = from_event_lists([[(EV_LD, 4, 2 * 64)], [(EV_LD, 4, 3 * 64)], [], []])
    g = GoldenSim(cfg, tr)
    g.run()
    te = t_engine.Engine(port_cfg(cfg), port_trace(tr), chunk_steps=8, device="cpu")
    te.run()
    lf = te.state.link_free.numpy()
    np.testing.assert_array_equal(lf + te.cycle_base, g.link_free)
    assert (lf != 0).any()
    cc = te.counters["noc_contention_cycles"]
    np.testing.assert_array_equal(cc, g.counters["noc_contention_cycles"])
    if mesh_y == 1:
        np.testing.assert_array_equal(cc[:2], [0, 1])
