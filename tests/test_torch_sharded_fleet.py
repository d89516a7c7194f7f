"""The port's sharded fleet (`FleetEngine(..., mesh=)`: the batch axis
whole, each element's cores and banks sharded within it) against the
JAX package, on the CPU: the mirrors of tests/test_pod_scale.py's
shard x vmap tests (:173, :190, :210, :232, :264, :314) and of
tests/test_attest.py:79. Every sharded fleet must equal the unsharded
JAX fleet bit for bit (integer simulator: tolerance 0); each JAX
reference fleet runs once per module (`_jax_fleet`).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    small_test_config,
)
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.fleet import FleetEngine as JFleet
from primesim_tpu.sim.fleet import apply_overrides as j_apply_overrides
from primesim_tpu.trace import synth
from primesim_tpu_torch import cli as tcli
from primesim_tpu_torch import convert
from primesim_tpu_torch.parallel import sharding
from primesim_tpu_torch.sim.checkpoint import load_fleet_checkpoint, save_fleet_checkpoint
from primesim_tpu_torch.sim.fleet import FleetEngine
from primesim_tpu_torch.sim.state import Shards

from test_torch_engine import jax_arrays, port_cfg, port_trace
from test_torch_fleet import assert_fleets_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the sharded step runs
    many mid-sized operators, one shard at a time, and beside the other
    test processes every parallel region would wait on descheduled
    threads (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVS = [
    {},
    {"llc_lat": 25, "dram_lat": 140, "l1_lat": 4},
    {"quantum": 150, "cpi": 2},
    {"link_lat": 3, "router_lat": 2},
]


def _cfg():
    return small_test_config(16, n_banks=8, quantum=200)


def _traces():
    return [
        synth.false_sharing(16, n_mem_ops=40, seed=11),
        synth.uniform_random(16, n_mem_ops=60, seed=12),
        synth.lock_contention(16, n_critical=6, seed=13),
        synth.fft_like(16, n_phases=2, points_per_core=8, seed=14),
    ]


def _faults_case():
    cfg = dataclasses.replace(_cfg(), faults_enabled=True, max_fault_events=1,
                              fault_events=((30, FAULT_CORE_FAILSTOP, 3, 0),))
    return cfg, [_traces()[1]] * 3, [{"fault_seed": 100 + i} for i in range(3)]


def _fork_case():
    cfg = dataclasses.replace(_cfg(), faults_enabled=True, max_fault_events=1,
                              fault_events=((40, FAULT_LINK_DEGRADE, 0, 3),))
    return cfg, [_traces()[3]] * 4, [{"fault_seed": 7 + i} for i in range(4)]


def _case(name):
    return {"sweep": lambda: (_cfg(), _traces(), OVS), "faults": _faults_case,
            "fork": _fork_case}[name]()


@functools.lru_cache(maxsize=None)
def _jax_fleet(name):
    cfg, traces, ovs = _case(name)
    f = JFleet(cfg, traces, ovs, chunk_steps=CHUNK)
    f.run()
    return f


def _fleet(name, mesh):
    cfg, traces, ovs = _case(name)
    return FleetEngine(port_cfg(cfg), [port_trace(t) for t in traces], ovs,
                       chunk_steps=CHUNK, mesh=mesh)


@pytest.mark.parametrize("devices", [4, 8])
def test_sharded_fleet_bit_exact_vs_unsharded_and_solo(devices):
    fleet = _fleet("sweep", sharding.tile_mesh(devices))
    fleet.run()
    assert_fleets_equal(_jax_fleet("sweep"), fleet)
    # one element against a solo JAX Engine of its effective config
    cfg, traces, _ = _case("sweep")
    solo = JEngine(j_apply_overrides(cfg, OVS[1]), traces[1], chunk_steps=CHUNK)
    solo.run()
    np.testing.assert_array_equal(fleet.cycles[1], np.asarray(solo.cycles))
    for k, v in fleet.element_counters(1).items():
        np.testing.assert_array_equal(v, np.asarray(solo.counters[k]), err_msg=k)
    es, js = convert.state_to_numpy(fleet.element_state(1)), jax_arrays(solo.state)
    for f in ("l1", "dirm", "cycles", "ptr", "quantum_end", "link_free"):
        np.testing.assert_array_equal(es[f], js[f], err_msg=f)


def test_sharded_fleet_state_is_actually_sharded():
    fleet = _fleet("sweep", sharding.tile_mesh(8))
    cyc = fleet.state.cycles
    assert isinstance(cyc, Shards) and cyc.axis == -1 and len(cyc) == 8
    assert tuple(cyc[0].shape) == (4, 2)  # the batch whole, 2 of 16 cores
    ev = fleet.events
    assert isinstance(ev, Shards) and ev.axis == -3 and ev[0].shape[:2] == (4, 2)
    assert fleet.state.dirm[0].shape[:2] == (4, fleet.cfg.llc.sets)
    assert cyc.mesh.ids == list(range(8))
    fleet.run()
    assert isinstance(fleet.state.cycles, Shards) and len(fleet.state.cycles) == 8


def test_sharded_fleet_fault_injection_parity():
    fleet = _fleet("faults", sharding.tile_mesh(8))
    fleet.run()
    assert_fleets_equal(_jax_fleet("faults"), fleet)
    assert int(fleet.state.faults.core_dead.cpu().sum()) > 0


def test_sharded_fleet_prefix_fork_parity():
    """Prefix forking writes fleet slots in place (fork_element): the
    sharded fleet copies each shard's block and stays bit-exact."""
    from primesim_tpu_torch.sim.prefix import execute_prefix_plan, plan_prefix

    forked = _fleet("fork", sharding.tile_mesh(8))
    groups = plan_prefix(forked.elem_cfgs, forked.traces, chunk_steps=CHUNK)
    assert groups and groups[0].prefix_steps > 0
    st = execute_prefix_plan(forked, groups)
    assert st["forked_elements"] == 4
    assert isinstance(forked.state.cycles, Shards)
    forked.run()
    assert_fleets_equal(_jax_fleet("fork"), forked)


def test_sharded_fleet_checkpoint_kill_resume_parity(tmp_path):
    """Saved mid-run on 8 shards, resumed on 4: equal to the uninterrupted
    JAX fleet."""
    first = _fleet("sweep", sharding.tile_mesh(8))
    first.run_steps(2 * CHUNK)
    path = str(tmp_path / "fleet.npz")
    save_fleet_checkpoint(path, first)
    del first
    resumed = _fleet("sweep", sharding.tile_mesh(4))
    load_fleet_checkpoint(path, resumed)
    assert isinstance(resumed.state.cycles, Shards) and len(resumed.state.cycles) == 4
    resumed.run()
    assert_fleets_equal(_jax_fleet("sweep"), resumed)


def test_chain_determinism_sharded():
    """test_attest.py:79: an 8-shard fleet commits the same chain as the
    unsharded fleet and as the JAX fleet: digests come from gathered host
    state, never from per-shard views."""
    from primesim_tpu.attest import FleetAttest as JFleetAttest
    from primesim_tpu.sim.supervisor import RunSupervisor as JSupervisor
    from primesim_tpu_torch.attest import FleetAttest
    from primesim_tpu_torch.sim.supervisor import RunSupervisor

    cfg = _cfg()
    trace = synth.uniform_random(16, n_mem_ops=60, seed=5)

    def run(mesh):
        fleet = FleetEngine(port_cfg(cfg), [port_trace(trace)], [{}], chunk_steps=16,
                            mesh=mesh, device="cpu" if mesh is None else None)
        fleet.attest = FleetAttest()
        fleet.attest.track(0, 16, start=0)
        RunSupervisor(fleet, handle_signals=False).run(max_steps=100_000)
        return fleet.attest.payload(0)

    jf = JFleet(cfg, [trace], [{}], chunk_steps=16)
    jf.attest = JFleetAttest()
    jf.attest.track(0, 16, start=0)
    JSupervisor(jf, handle_signals=False).run(max_steps=100_000)
    sharded = run(sharding.tile_mesh(8))
    assert sharded["chunks"] > 1
    assert sharded == run(None) == jf.attest.payload(0)


def test_cli_sweep_devices_bit_exact_vs_unsharded(capsys):
    """test_pod_scale.py:314: `sweep --devices 8` prints the lines of the
    unsharded sweep (but for the wall clock)."""
    cfg_path = os.path.join(REPO, "configs", "rung1_64core_fft.json")
    base = ["sweep", cfg_path, "--synth", "fft_like:n_phases=1,points_per_core=8",
            "--vary", "llc_lat=10", "--vary", "llc_lat=20", "--chunk-steps", "64",
            "--device", "cpu"]

    def run(extra):
        assert tcli.main(base + extra) == 0
        lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
        for d in lines:
            d["detail"].pop("wall_s", None)
            d["value"] = None  # MIPS embeds wall clock
        return lines

    sharded = run(["--devices", "8"])
    assert len(sharded) >= 3 and sharded == run([])
