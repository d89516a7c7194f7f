"""NoC contention (tile and link models) and the DRAM controller queue in
the port against the JAX package, on the CPU, and the router with the
queue on a rung-3-shaped machine.

Whole runs: the port's `Engine(device="cpu")` against the JAX `Engine`
(XLA and Pallas steps) and the golden model, on the machines and traces
of tests/test_contention.py, tests/test_dram.py and
tests/test_router_pallas.py, and on a 64-core 8x8 machine with rung 3's
models (router, DRAM queue, O3, local runs) on a folded fft_like trace.
One step from a JAX mid-run state whose link and controller clocks are
live. A run that rebases many times, with clocks pushed down to the
rebase clamp, field by field. The CLI report on a router + DRAM machine
equals the JAX package's. Every comparison is exact.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
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
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.engine import run_chunk as j_run_chunk
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import EV_LD, fold_ins, from_event_lists
from primesim_tpu_torch import convert
from primesim_tpu_torch.config.machine import check_port_supported
from primesim_tpu_torch.sim import engine as t_engine

from test_torch_engine import (
    assert_engines_equal,
    assert_port_matches_everything,
    assert_states_equal,
    jax_arrays,
    port_cfg,
    port_trace,
)
from test_torch_rules import _report_body

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNG3 = os.path.join(REPO, "configs", "rung3_1024core_o3.json")


def cfg4(**kw):
    """tests/test_contention.py's tile-model machine."""
    return small_test_config(
        4,
        noc=NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1,
                      contention=True, contention_lat=1),
        **kw,
    )


TILE_TRACES = {
    "false_sharing": lambda: synth.false_sharing(4, n_mem_ops=40, seed=51),
    "uniform_random": lambda: synth.uniform_random(4, n_mem_ops=50, seed=52),
    "lock_contention": lambda: synth.lock_contention(4, n_critical=8, seed=53),
    "barrier_phases": lambda: synth.barrier_phases(4, n_phases=2, seed=54),
}


@pytest.mark.parametrize("gen", sorted(TILE_TRACES))
def test_tile_model_runs(gen):
    assert_port_matches_everything(
        cfg4(n_banks=4, quantum=300), TILE_TRACES[gen](), chunk_steps=50
    )


def test_tile_model_8core_hot_bank():
    cfg = small_test_config(
        8, n_banks=4,
        noc=NocConfig(mesh_x=2, mesh_y=2, contention=True, contention_lat=3),
    )
    evs = [[(EV_LD, 4, (4 * i) * 64) for i in range(6)] for _ in range(8)]
    te = assert_port_matches_everything(cfg, from_event_lists(evs), chunk_steps=256)
    assert te.counters["noc_contention_cycles"].sum() > 0


def _link_cfg():
    """tests/test_contention.py's link-model machine."""
    return small_test_config(
        8, n_banks=4, quantum=300,
        noc=NocConfig(mesh_x=4, mesh_y=2, contention=True,
                      contention_model="link", contention_lat=2),
    )


LINK_TRACES = {
    "false_sharing": lambda: synth.false_sharing(8, n_mem_ops=40, seed=71),
    "lock_contention": lambda: synth.lock_contention(8, n_critical=8, seed=72),
    "barrier_phases": lambda: synth.barrier_phases(8, n_phases=2, seed=73),
}


@pytest.mark.parametrize("gen", sorted(LINK_TRACES))
def test_link_model_runs(gen):
    te = assert_port_matches_everything(_link_cfg(), LINK_TRACES[gen](), chunk_steps=50)
    assert te.counters["noc_contention_cycles"].sum() > 0


def test_link_model_16core_hot_path():
    cfg = MachineConfig(
        n_cores=16, n_banks=16,
        l1=CacheConfig(size=1024, ways=2, line=64, latency=2),
        llc=CacheConfig(size=8192, ways=4, line=64, latency=10),
        noc=NocConfig(mesh_x=4, mesh_y=4, contention=True,
                      contention_model="link", contention_lat=1),
        quantum=400,
    )
    evs = [[(EV_LD, 4, ((c + i) % 16) * 64) for i in range(8)] for c in range(16)]
    assert_port_matches_everything(cfg, from_event_lists(evs), chunk_steps=50)


def qcfg(n=4, **kw):
    """tests/test_dram.py's queued-controller machine."""
    kw.setdefault("n_banks", 4)
    kw.setdefault("quantum", 400)
    return small_test_config(n, dram_queue=True, **kw)


DRAM_TRACES = {
    "false_sharing": lambda: synth.false_sharing(8, n_mem_ops=40, seed=21),
    "uniform_random": lambda: synth.uniform_random(8, n_mem_ops=50, seed=22),
    "barrier_phases": lambda: synth.barrier_phases(8, n_phases=2, seed=23),
}


@pytest.mark.parametrize("gen", sorted(DRAM_TRACES))
def test_dram_queue_runs(gen):
    assert_port_matches_everything(qcfg(8, n_banks=4), DRAM_TRACES[gen](), chunk_steps=50)


def test_dram_queue_same_bank_misses_and_carry():
    # tests/test_dram.py's hand cases: two same-bank misses in one step,
    # and a late miss queueing behind a carried controller clock
    cases = [
        (qcfg(), [[(EV_LD, 4, 0)], [(EV_LD, 4, 4 * 64)], [], []]),
        (qcfg(dram_service=150),
         [[(EV_LD, 4, 0), (EV_LD, 4, 4 * 64), (EV_LD, 4, 8 * 64)],
          [(EV_LD, 400, 12 * 64)], [], []]),
    ]
    for cfg, evs in cases:
        te = assert_port_matches_everything(cfg, from_event_lists(evs), chunk_steps=8)
        assert te.counters["dram_queue_cycles"].sum() > 0


def _router_dram_cfg(**kw):
    """tests/test_dram.py's stack of every timing model."""
    kw.setdefault("local_run_len", 4)
    return small_test_config(
        8, n_banks=8, quantum=500, dram_queue=True, dram_service=40,
        core=CoreConfig(o3_overlap_256=64),
        noc=NocConfig(mesh_x=4, mesh_y=2, contention=True,
                      contention_model="router"),
        **kw,
    )


def test_router_dram_runs_and_o3():
    tr = fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=24))
    te = assert_port_matches_everything(_router_dram_cfg(), tr, chunk_steps=16)
    assert te.counters["dram_queue_cycles"].sum() > 0


def test_router_plus_dram_queue_pallas_machine():
    # tests/test_router_pallas.py: both FIFO blocks share one lane order
    noc = NocConfig(
        mesh_x=2, mesh_y=2, link_lat=1, router_lat=1,
        contention=True, contention_model="router", contention_lat=2,
    )
    cfg = small_test_config(8, n_banks=4, quantum=400, noc=noc,
                            dram_queue=True, dram_service=8)
    tr = synth.uniform_random(8, n_mem_ops=60, seed=31)
    te = assert_port_matches_everything(cfg, tr, chunk_steps=32)
    assert te.counters["dram_queue_cycles"].sum() > 0
    assert te.counters["noc_contention_cycles"].sum() > 0


def rung3_shaped(**kw):
    """Rung 3's machine at 64 cores on an 8x8 mesh: router NoC, DRAM
    queue, O3 overlap, local runs of 8, rung 3's caches and latencies."""
    with open(RUNG3) as f:
        cfg = MachineConfig.from_json(f.read())
    return dataclasses.replace(
        cfg, n_cores=64, n_banks=64,
        noc=dataclasses.replace(cfg.noc, mesh_x=8, mesh_y=8), **kw,
    )


def test_rung3_config_is_supported():
    from primesim_tpu_torch.config.machine import MachineConfig as TCfg

    with open(RUNG3) as f:
        cfg = TCfg.from_json(f.read())
    check_port_supported(cfg)
    assert cfg.noc.contention_model == "router" and cfg.dram_queue


RUNG3_TRACES = {
    # the headline trace's shape: memory and INS events, no sync
    "fft_folded": lambda: fold_ins(
        synth.fft_like(64, n_phases=2, points_per_core=16, seed=7)
    ),
    # barriers drive the router's arrival leg
    "barriers": lambda: synth.barrier_phases(64, n_phases=2, work_per_phase=6, seed=9),
}


@pytest.mark.parametrize("trace", sorted(RUNG3_TRACES))
def test_rung3_shaped_64core(trace):
    te = assert_port_matches_everything(
        rung3_shaped(), RUNG3_TRACES[trace](), chunk_steps=64
    )
    cnt = te.counters
    assert cnt["noc_contention_cycles"].sum() > 0 and cnt["dram_queue_cycles"].sum() > 0
    assert (cnt["barrier_waits"].sum() > 0) == (trace == "barriers")


@pytest.mark.parametrize("rl", [0, 4])
def test_one_step_from_a_jax_state_with_live_clocks(rl):
    cfg = _router_dram_cfg(local_run_len=rl, step_impl="pallas")
    tr = synth.barrier_phases(8, n_phases=3, seed=9)
    je = JEngine(cfg, tr, chunk_steps=24)
    je.run_steps(24)
    assert not je.done()
    assert np.asarray(je.state.link_free).any() and np.asarray(je.state.dram_free).any()
    tcfg = port_cfg(cfg)
    tst = convert.state_from_numpy(tcfg, jax_arrays(je.state), "cpu")
    assert_states_equal(je.state, tst, "carried")
    events = torch.from_numpy(tr.line_events(cfg.line_bits))
    j_next = j_run_chunk(cfg, 1, je.events, je.state, has_sync=je.has_sync)
    t_next = t_engine.step(tcfg, events, tst, has_sync=je.has_sync)
    assert_states_equal(j_next, t_next, "after one step")
    assert not np.array_equal(np.asarray(j_next.link_free), np.asarray(je.state.link_free))


def test_rebases_shift_and_clamp_the_link_and_controller_clocks():
    cfg = _router_dram_cfg()
    tr = fold_ins(synth.fft_like(8, n_phases=3, points_per_core=24, seed=25))
    je = JEngine(cfg, tr, chunk_steps=8)
    te = t_engine.Engine(port_cfg(cfg), port_trace(tr), chunk_steps=8, device="cpu")
    je.run_steps(32)
    te.run_steps(32)
    assert_engines_equal(je, te, "before")
    assert te.cycle_base > 0
    # idle clocks at the rebase clamp: the next rebase must hold them there
    lf = np.asarray(je.state.link_free).copy()
    df = np.asarray(je.state.dram_free).copy()
    lf[::3] = -(1 << 30) + 3
    df[::2] = -(1 << 30) + 1
    je.state = je.state._replace(link_free=jnp.asarray(lf), dram_free=jnp.asarray(df))
    te.state = te.state._replace(
        link_free=torch.from_numpy(lf), dram_free=torch.from_numpy(df)
    )
    base = te.cycle_base
    je.run_steps(40)
    te.run_steps(40)
    assert te.cycle_base > base
    assert_engines_equal(je, te, "after")
    assert (te.state.link_free == -(1 << 30)).any()
    assert (te.state.dram_free == -(1 << 30)).any()
    assert (te.state.link_free > 0).any() or (te.state.link_free < 0).any()


def test_models_off_leave_the_clocks_zero():
    cfg = small_test_config(8, n_banks=4, quantum=300)
    te = t_engine.Engine(
        port_cfg(cfg), port_trace(synth.uniform_random(8, n_mem_ops=60, seed=3)),
        chunk_steps=8, device="cpu",
    )
    te.run()
    assert te.cycle_base > 0
    assert not te.state.link_free.any() and not te.state.dram_free.any()


def test_cli_report_on_a_router_dram_machine(tmp_path):
    from primesim_tpu.cli import main as jax_main

    cfg_path = tmp_path / "rung3_64.json"
    cfg_path.write_text(rung3_shaped().to_json())
    spec = "fft_like:n_phases=1,points_per_core=6,ins_per_mem=4,seed=3"
    j_rep, t_rep = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jax_main(
        ["run", str(cfg_path), "--synth", spec, "--fold", "--engine", "jax",
         "--chunk-steps", "16", "--report", str(j_rep)]
    ) == 0
    r = subprocess.run(
        [sys.executable, "-m", "primesim_tpu_torch", "run", str(cfg_path),
         "--synth", spec, "--fold", "--chunk-steps", "16", "--device", "cpu",
         "--report", str(t_rep)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    detail = json.loads(r.stdout.strip().splitlines()[-1])["detail"]
    assert detail["engine"] == "torch" and detail["instructions"] > 0
    body = _report_body(t_rep)
    assert body == _report_body(j_rep)
    text = "".join(body)
    assert "NoC contention cyc" in text and "DRAM queue cycles" in text
