"""The port's engine against the JAX package, on the CPU.

Whole runs: the port's `Engine(device="cpu")` against the JAX `Engine`
with the XLA step and with the Pallas step, and against the golden
model, on every workload generator at the shapes of
tests/test_step_pallas.py. One step: a JAX state taken mid-run crosses
into the port (`convert.state_from_numpy`) and both packages take the
same step from it. Bit-exact everywhere: cycles, all 26 counters and
every state field.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import small_test_config
from primesim_tpu.golden.sim import GoldenSim
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.engine import run_chunk as j_run_chunk
from primesim_tpu.sim.validate import (
    I,
    effective_l1_state,
    engine_l1_to_golden,
    epoch_views,
    l1_views,
    llc_views,
    sharers_view,
)
from primesim_tpu.trace import synth
from primesim_tpu_torch import convert
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.trace.format import Trace as TTrace

from test_step_pallas import GENERATOR_TRACES


def port_cfg(cfg):
    return TCfg.from_json(cfg.to_json())


def port_trace(tr):
    return TTrace(tr.events, tr.lengths, tr.line_addressed, tr.line_bits)


def jax_arrays(st):
    """A JAX MachineState as the numpy mapping convert.state_from_numpy
    takes: the timing knobs and the fault state as nested mappings."""
    nested = ("knobs", "faults")
    out = {f: np.asarray(getattr(st, f)) for f in st._fields if f not in nested}
    for n in nested:
        out[n] = {k: np.asarray(v) for k, v in getattr(st, n)._asdict().items()}
    return out


def assert_states_equal(jst, tst, where=""):
    t = convert.state_to_numpy(tst)
    j = jax_arrays(jst)
    assert set(t) == set(j)
    for f in j:
        if isinstance(j[f], dict):  # the knobs and the fault state
            assert set(t[f]) == set(j[f])
            for k in j[f]:
                np.testing.assert_array_equal(t[f][k], j[f][k], err_msg=f"{where} {f}.{k}")
        else:
            np.testing.assert_array_equal(t[f], j[f], err_msg=f"{where} state field {f}")


def assert_engines_equal(je, te, where=""):
    np.testing.assert_array_equal(te.cycles, je.cycles, err_msg=f"{where} cycles")
    assert te.steps_run == je.steps_run
    jc, tc = je.counters, te.counters
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=f"{where} counter {k}")
    assert_states_equal(je.state, te.state, where)


def assert_golden_equal(cfg, trace, te):
    """Port vs the golden model, as tests/test_parity.py holds the JAX
    engine: the golden's eager MESI state equals the port's
    directory-validated state, and every table and counter agrees."""
    g = GoldenSim(cfg, trace)
    g.run()
    st = SimpleNamespace(**convert.state_to_numpy(te.state))
    np.testing.assert_array_equal(te.cycles, g.cycles, err_msg="golden cycles")
    np.testing.assert_array_equal(st.ptr, g.ptr, err_msg="golden ptr")
    tag, state, lru, _ = l1_views(cfg, st)
    llc_tag, llc_owner, llc_lru = llc_views(cfg, st)
    l1_eph, llc_eph = (
        epoch_views(cfg, st) if cfg.sharer_group > 1 else (None, None)
    )
    eff = effective_l1_state(
        cfg, tag, state, llc_tag, llc_owner, sharers_view(cfg, st),
        l1_eph=l1_eph, llc_eph=llc_eph,
    )
    np.testing.assert_array_equal(eff, g.l1_state, err_msg="golden l1_state")
    valid = g.l1_state != I
    np.testing.assert_array_equal(
        np.where(valid, engine_l1_to_golden(cfg, tag), -1),
        np.where(valid, g.l1_tag, -1),
        err_msg="golden l1_tag",
    )
    np.testing.assert_array_equal(llc_tag, g.llc_tag, err_msg="golden llc_tag")
    np.testing.assert_array_equal(llc_owner, g.llc_owner, err_msg="golden llc_owner")
    np.testing.assert_array_equal(
        sharers_view(cfg, st).reshape(g.sharers.shape), g.sharers,
        err_msg="golden sharers",
    )
    np.testing.assert_array_equal(st.lock_holder, g.lock_holder)
    np.testing.assert_array_equal(st.barrier_count, g.barrier_count)
    np.testing.assert_array_equal(st.sync_flag, g.sync_flag)
    tc = te.counters
    for k, v in g.counters.items():
        np.testing.assert_array_equal(tc[k], v, err_msg=f"golden counter {k}")
    np.testing.assert_array_equal(
        engine_l1_to_golden(cfg, lru), g.l1_lru, err_msg="golden l1_lru"
    )
    np.testing.assert_array_equal(llc_lru, g.llc_lru, err_msg="golden llc_lru")


def assert_port_matches_everything(cfg, trace, chunk_steps):
    """The port's run against JAX/XLA, JAX/Pallas and the golden model."""
    te = t_engine.Engine(port_cfg(cfg), port_trace(trace), chunk_steps, device="cpu")
    te.run()
    te.verify_invariants()
    for impl in ("xla", "pallas"):
        je = JEngine(dataclasses.replace(cfg, step_impl=impl), trace, chunk_steps)
        je.run()
        assert_engines_equal(je, te, impl)
    assert_golden_equal(cfg, trace, te)
    return te


@pytest.mark.parametrize("gen", sorted(GENERATOR_TRACES))
def test_whole_run_matches_jax_and_golden(gen):
    cfg = small_test_config(8, n_banks=4, quantum=300)
    assert_port_matches_everything(cfg, GENERATOR_TRACES[gen](), chunk_steps=32)


@pytest.mark.parametrize(
    "gen,rl,steps",
    [("false_sharing", 4, 40), ("lock_contention", 0, 64), ("barrier_phases", 2, 48)],
)
def test_one_step_from_a_jax_mid_run_state(gen, rl, steps):
    cfg = small_test_config(8, n_banks=4, quantum=300, local_run_len=rl,
                            step_impl="pallas")
    tr = GENERATOR_TRACES[gen]()
    je = JEngine(cfg, tr, chunk_steps=steps)
    je.run_steps(steps)  # one chunk in, mid-run
    assert not je.done()
    tcfg = port_cfg(cfg)
    tst = convert.state_from_numpy(tcfg, jax_arrays(je.state), "cpu")
    assert_states_equal(je.state, tst, "carried")
    events = torch.from_numpy(tr.line_events(cfg.line_bits))
    j_next = j_run_chunk(cfg, 1, je.events, je.state, has_sync=je.has_sync)
    t_next = t_engine.step(tcfg, events, tst, has_sync=je.has_sync)
    assert_states_equal(j_next, t_next, "after one step")
    # and back into the JAX package's numpy layout
    back = convert.state_to_numpy(t_next)
    np.testing.assert_array_equal(back["dirm"], np.asarray(j_next.dirm))


def test_64_cores_two_sharer_words():
    # 64 cores: two sharer words per entry, a small LLC with
    # back-invalidations, a 4x4 mesh (tests/test_step_pallas.py shape)
    from primesim_tpu.config.machine import CacheConfig, MachineConfig, NocConfig

    cfg = MachineConfig(
        n_cores=64, n_banks=16,
        l1=CacheConfig(size=1024, ways=2, line=64, latency=2),
        llc=CacheConfig(size=4096, ways=4, line=64, latency=10),
        noc=NocConfig(mesh_x=4, mesh_y=4), quantum=500,
    )
    tr = synth.readers_writer(64, n_rounds=2, block_lines=4, seed=14)
    te = assert_port_matches_everything(cfg, tr, chunk_steps=32)
    assert te.counters["invalidations"].sum() > 0


def test_o3_overlap_and_heterogeneous_cpi():
    # the O3 latency reduction and a per-core CPI vector (big.LITTLE
    # pattern) both flow through the knobs the port carries in its state
    from primesim_tpu.config.machine import CoreConfig

    cfg = small_test_config(
        8, n_banks=4, quantum=300, local_run_len=2,
        core=CoreConfig(cpi=1, cpi_pattern=(1, 3), o3_overlap_256=96),
    )
    assert_port_matches_everything(cfg, GENERATOR_TRACES["fft_like"](), chunk_steps=32)


def test_step_commits_in_place():
    """`step` updates the L1, the directory and the counters in place:
    the new state holds the same tensors, with the step's writes in them,
    and equals the JAX step from the same state."""
    cfg = small_test_config(8, n_banks=4, quantum=300, local_run_len=2,
                            step_impl="pallas")
    tr = GENERATOR_TRACES["false_sharing"]()
    je = JEngine(cfg, tr, chunk_steps=16)
    je.run_steps(16)
    tcfg = port_cfg(cfg)
    tst = convert.state_from_numpy(tcfg, jax_arrays(je.state), "cpu")
    before = {f: getattr(tst, f).clone() for f in ("l1", "dirm", "counters")}
    events = torch.from_numpy(tr.line_events(cfg.line_bits))
    t_next = t_engine.step(tcfg, events, tst, has_sync=je.has_sync)
    for f, old in before.items():
        assert getattr(t_next, f) is getattr(tst, f), f
        assert not torch.equal(getattr(t_next, f), old), f
    j_next = j_run_chunk(cfg, 1, je.events, je.state, has_sync=je.has_sync)
    assert_states_equal(j_next, t_next, "in place")
