"""The hop-by-hop router in the port against the JAX package, on the CPU.

The kernel: `router_cascade_plain`, which the CUDA kernel is held to on
the card (chip_smoke.py), against the JAX package's Pallas
`router_cascade` in interpret mode, on numpy-seeded inputs at the route
widths of 2x2, 4x4 and 32x32 meshes (H = 2, 6 and 62), with and without
the barrier-arrival leg, about half the hops masked and link clocks down
at the rebase clamp.

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


def _cascade_inputs(C, H, has_sync, seed):
    rng = np.random.default_rng(seed)
    LT = (3 if has_sync else 2) * H
    # link clocks from the rebase clamp up to live values; base from real
    # arrivals or the empty-link INT32_MAX
    lf = np.where(
        rng.random((C, LT)) < 0.3,
        -(1 << 30) + rng.integers(0, 50, (C, LT)),
        rng.integers(-2000, 5000, (C, LT)),
    )
    bs = np.where(
        rng.random((C, LT)) < 0.1, 2**31 - 1, rng.integers(-500, 5000, (C, LT))
    )
    ok = rng.random((C, LT)) < 0.5
    bs = np.where(ok, np.minimum(bs, 10_000), bs)  # a real hop has a real base
    r = rng.integers(0, 40, (C, LT))
    lanes = [
        rng.integers(-1000, 5000, C),  # t0
        rng.integers(1, 400, C),  # service
        *(rng.integers(0, H + 1, C) for _ in range(3)),  # req/rep/arr hops
    ]
    i32 = [a.astype(np.int32) for a in (lf, bs, r)]
    return i32 + [ok] + [a.astype(np.int32) for a in lanes]


@pytest.mark.parametrize("has_sync", [False, True])
@pytest.mark.parametrize("mesh,C", [((2, 2), 8), ((4, 4), 16), ((32, 32), 64)])
def test_cascade_plain_matches_pallas(mesh, C, has_sync):
    import jax.numpy as jnp

    assert router_kernels.SENT == J_SENT
    H = (mesh[0] - 1) + (mesh[1] - 1)
    arrs = _cascade_inputs(C, H, has_sync, seed=H * 10 + has_sync)
    for L, R in ((1, 1), (3, 2)):
        want = j_cascade(
            *[jnp.asarray(a) for a in arrs], L, R, has_sync=has_sync
        )
        t = [torch.from_numpy(a) for a in arrs]
        got = router_kernels.router_cascade(
            *t[:8], t[8] if has_sync else None,
            torch.tensor(L, dtype=torch.int32), torch.tensor(R, dtype=torch.int32),
            has_sync=has_sync,
        )
        names = ("t_rep_end", "t_arr_end", "departs")
        for n, a, b in zip(names, want, got):
            if n == "t_arr_end" and not has_sync:
                assert a is None and b is None
                continue
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)


def test_cascade_wraps_like_jax():
    """Floors and clocks near the int32 limits wrap in both packages."""
    import jax.numpy as jnp

    arrs = _cascade_inputs(8, 2, True, seed=5)
    arrs[0][:, :] = 2**31 - 3  # max(lf, bs) + rank*L wraps past INT32_MAX
    arrs[3][:, :] = True
    arrs[4][:] = 2**31 - 2  # t0 + R wraps
    want = j_cascade(*[jnp.asarray(a) for a in arrs], 2, 1, has_sync=True)
    t = [torch.from_numpy(a) for a in arrs]
    got = router_kernels.router_cascade(
        *t, torch.tensor(2, dtype=torch.int32), torch.tensor(1, dtype=torch.int32),
        has_sync=True,
    )
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_cascade_wrapper_checks_its_device_and_counts_nothing_on_cpu():
    arrs = [torch.from_numpy(a) for a in _cascade_inputs(8, 2, False, seed=1)]
    one = torch.tensor(1, dtype=torch.int32)
    before = dict(build.LAUNCHES)
    router_kernels.router_cascade(*arrs[:8], None, one, one, has_sync=False)
    assert build.LAUNCHES == before
    assert "router_cascade" in build.KERNELS
    with pytest.raises(ValueError, match="unsupported device"):
        router_kernels.router_cascade(
            *[a.to("meta") for a in arrs[:8]], None, one.to("meta"),
            one.to("meta"), has_sync=False,
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
