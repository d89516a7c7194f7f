"""The port's tile mesh (`parallel/sharding.py`, the sharded step) against
the JAX package, on the CPU.

The mesh's shards all live on the CPU here; their count mirrors the JAX
tests' 8 virtual devices (tests/conftest.py sets XLA_FLAGS, which the
port's visible-device count reads too). Every sharded run must equal the
unsharded JAX `Engine` bit for bit: cycles, all 26 counters and every
`MachineState` field (integer simulator: tolerance 0). Each JAX reference
run is made once per module (`_jax_run`).

Covered: the placement table and the device checks against JAX's; the
mirrors of tests/test_multichip.py, test_pod_scale.py's validation and
CLI tests, test_degrade.py's reshard and kill-and-resume tests,
test_checkpoint.py's mesh resume, test_attest.py's sharded chain and
test_cli.py's `--devices` run; sharded MOESI, torus, coarse, router +
DRAM queue + O3 and faulted machines; the kernels' staged-rows and
delta-row modes against the Pallas kernels in interpret mode; and the
rule that a step moves directory rows only by request.
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    FAULT_LINK_FAIL,
    CacheConfig,
    CoreConfig,
    MachineConfig,
    NocConfig,
    small_test_config,
)
from primesim_tpu.parallel import sharding as j_sharding
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import synth
from primesim_tpu_torch import cli as tcli
from primesim_tpu_torch.chaos import plan as t_plan
from primesim_tpu_torch.chaos import sites as t_sites
from primesim_tpu_torch.kernels import reductions, step_kernels
from primesim_tpu_torch.parallel import sharding
from primesim_tpu_torch.parallel.distributed import global_tile_mesh, process_info
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.sim.state import Shards, dirm_width
from primesim_tpu_torch.sim.supervisor import RunSupervisor, classify_failure

from test_torch_engine import assert_engines_equal, port_cfg, port_trace
from test_torch_kernels import (
    JAX_PROBE_LANES,
    _bool_patch,
    _cfgs,
    _commit_inputs,
    _probe_inputs,
    _stage,
)
from primesim_tpu.kernels.step_kernels import commit_step as j_commit
from primesim_tpu.kernels.step_kernels import probe_classify as j_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


GENS = {
    "uniform_random": lambda n: synth.uniform_random(n, n_mem_ops=80, seed=7),
    "false_sharing": lambda n: synth.false_sharing(n, n_mem_ops=40, seed=3),
    "fft_like": lambda n: synth.fft_like(n, n_phases=2, points_per_core=8, seed=5),
}
CFG256 = MachineConfig(
    n_cores=256, n_banks=256,
    l1=CacheConfig(size=1024, ways=2, line=64, latency=2),
    llc=CacheConfig(size=4096, ways=4, line=64, latency=12),
    noc=NocConfig(mesh_x=16, mesh_y=16), quantum=600,
)
MACHINES = {
    "moesi": (small_test_config(8, n_banks=4, coherence="moesi", local_run_len=2),
              lambda: synth.false_sharing(8, n_mem_ops=40, seed=3)),
    "torus": (small_test_config(16, n_banks=4, noc=NocConfig(
        mesh_x=4, mesh_y=4, topology="torus")),
        lambda: synth.readers_writer(16, n_rounds=2, seed=9)),
    "coarse": (small_test_config(16, n_banks=4, sharer_group=4),
               lambda: synth.uniform_random(16, n_mem_ops=60, seed=12)),
    "router_dram_o3": (small_test_config(
        8, n_banks=8, local_run_len=4, dram_queue=True, dram_service=8,
        prefetcher="stride", core=CoreConfig(o3_overlap_256=64),
        noc=NocConfig(mesh_x=2, mesh_y=2, contention=True, contention_model="router",
                      contention_lat=2)),
        lambda: synth.false_sharing(8, n_mem_ops=40, seed=77)),
    "faults": (dataclasses.replace(
        small_test_config(8, n_banks=4, quantum=200), faults_enabled=True,
        max_fault_events=3, fault_seed=5, fault_events=(
            (20, FAULT_CORE_FAILSTOP, 3, 0), (5, FAULT_LINK_FAIL, 0, 0),
            (8, FAULT_LINK_DEGRADE, 2, 7)),
        fault_flip_l1=0.01, fault_flip_llc=0.02, fault_due_rate=0.3,
        fault_due_failstop=True),
        lambda: synth.uniform_random(8, n_mem_ops=96, shared_frac=0.4, seed=3)),
}


@pytest.fixture(autouse=True)
def _healthy_pool():
    yield
    t_sites.deactivate()
    sharding.restore_devices()
    sharding.virtual_devices(None)


@functools.lru_cache(maxsize=None)
def _jax_run(case: str, chunk_steps: int = 64):
    """The unsharded JAX engine's run of a named case, once per module."""
    cfg, tr = _case(case)
    e = JEngine(cfg, tr, chunk_steps=chunk_steps)
    e.run()
    return e


def _case(case: str):
    if case in GENS:
        return small_test_config(n_cores=16, n_banks=8), GENS[case](16)
    if case in MACHINES:
        cfg, gen = MACHINES[case]
        return cfg, gen()
    return {
        "stream16": (small_test_config(n_cores=16, n_banks=8), synth.stream(16, n_mem_ops=96)),
        "rw256": (CFG256, synth.readers_writer(256, n_rounds=2, block_lines=4, seed=93)),
        "rw8": (small_test_config(8, n_banks=8),
                synth.readers_writer(8, n_rounds=2, seed=92)),
        "fs8": (small_test_config(8, n_banks=8), synth.false_sharing(8, n_mem_ops=24, seed=44)),
        "fft8": (small_test_config(8, n_banks=8),
                 synth.fft_like(8, n_phases=1, points_per_core=12, seed=7)),
    }[case]


def _sharded(case: str, n: int, chunk_steps: int = 64, run: bool = True):
    cfg, tr = _case(case)
    e = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=chunk_steps,
               mesh=sharding.tile_mesh(n))
    if run:
        e.run()
    return e


# ---- the placement table and the device checks -----------------------------


def _specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    return [v for f in tree for v in (_port_specs(f) if hasattr(f, "_fields") else (f,))]


def test_placement_table_is_the_jax_one_field_for_field():
    """state_pspecs() and its fleet form equal the JAX package's, field
    for field (nested knobs and fault state included), and so do the
    events' specs; test_pod_scale.py:121's axes hold."""
    jt, tt = j_sharding.state_pspecs(), sharding.state_pspecs()
    assert tt._fields == jt._fields
    assert _port_specs(tt) == _specs(jt)
    for f in ("knobs", "faults"):
        assert getattr(tt, f)._fields == getattr(jt, f)._fields
    assert _port_specs(sharding.fleet_state_pspecs()) == _specs(j_sharding.fleet_state_pspecs())
    assert sharding.events_pspec() == tuple(j_sharding.events_pspec())
    assert sharding.fleet_events_pspec() == tuple(j_sharding.fleet_events_pspec())
    assert tt.cycles == tt.dirm == tt.faults.core_dead == (sharding.AXIS,)
    assert tt.counters == (None, sharding.AXIS)


def _mesh_error(fn, *args):
    try:
        fn(*args)
    except (j_sharding.DeviceMeshError, sharding.DeviceMeshError) as e:
        return type(e).__name__, str(e), e.location()
    return None


def test_device_checks_match_jax_over_a_grid():
    """validate_devices and largest_valid_submesh give JAX's results,
    messages and locations over cores x banks x N, 8 devices visible."""
    assert len(sharding.visible_devices("cpu")) == len(jax.devices()) == 8
    for cores, banks in ((16, 8), (16, 4), (8, 8), (12, 4), (24, 8), (64, 16), (8, 2)):
        jc = small_test_config(cores, n_banks=banks)
        tc = port_cfg(jc)
        for n in range(-1, 18):
            assert _mesh_error(sharding.validate_devices, tc, n, "cpu") == _mesh_error(
                j_sharding.validate_devices, jc, n), (cores, banks, n)
        for n in range(0, 10):
            assert _mesh_error(sharding.largest_valid_submesh, tc, n) == _mesh_error(
                j_sharding.largest_valid_submesh, jc, n), (cores, banks, n)
            if n:
                assert sharding.largest_valid_submesh(tc, n) == \
                    j_sharding.largest_valid_submesh(jc, n)


def test_validate_devices_typed_errors():
    """test_pod_scale.py:132."""
    cfg = port_cfg(small_test_config(16, n_banks=8, quantum=200))
    sharding.validate_devices(cfg, 8, "cpu")
    with pytest.raises(sharding.DeviceMeshError) as e:
        sharding.validate_devices(cfg, 5, "cpu")
    assert e.value.location() == {"devices": 5, "visible": 8}
    with pytest.raises(sharding.DeviceMeshError) as e:
        sharding.validate_devices(cfg, 16, "cpu")
    assert "visible" in str(e.value)
    with pytest.raises(sharding.DeviceMeshError):
        sharding.validate_devices(cfg, 0, "cpu")
    with pytest.raises(sharding.DeviceMeshError) as e:
        sharding.validate_devices(port_cfg(small_test_config(16, n_banks=4)), 8, "cpu")
    assert "n_banks" in str(e.value)


def test_largest_valid_submesh():
    """test_degrade.py:252."""
    cfg = port_cfg(MachineConfig(n_cores=8, n_banks=8))
    assert [sharding.largest_valid_submesh(cfg, n) for n in (8, 7, 3, 1)] == [8, 4, 2, 1]
    with pytest.raises(sharding.DeviceMeshError):
        sharding.largest_valid_submesh(cfg, 0)
    assert sharding.largest_valid_submesh(port_cfg(MachineConfig(n_cores=8, n_banks=4)), 8) == 4


def test_device_loss_classifies_before_the_value_error_guard():
    """test_degrade.py:238: a DeviceMeshError is a ValueError, and it is
    device loss."""
    assert classify_failure(RuntimeError("DEVICE_LOST: chip 3")) == "device_loss"
    assert classify_failure(
        sharding.DeviceMeshError("mesh broke", devices=4, visible=2)) == "device_loss"
    assert classify_failure(ValueError("plain bug")) is None


def test_virtual_devices_and_revocation():
    """n ids on one device make a mesh that can lose a shard; revoked
    ids leave the healthy set until restored."""
    sharding.virtual_devices(4, "cpu")
    assert [d.id for d in sharding.visible_devices()] == [0, 1, 2, 3]
    mesh = sharding.tile_mesh(4)
    assert mesh.ids == [0, 1, 2, 3] and mesh.platform == "cpu"
    sharding.revoke_devices([3])
    assert [d.id for d in sharding.healthy_devices()] == [0, 1, 2]
    sharding.restore_devices([3])
    assert len(sharding.healthy_devices()) == 4
    with pytest.raises(ValueError, match="5 devices requested"):
        sharding.tile_mesh(5)


# ---- tests/test_multichip.py ------------------------------------------------


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("gen", list(GENS))
def test_sharded_parity(gen, n):
    assert_engines_equal(_jax_run(gen), _sharded(gen, n), f"{gen} on {n}")


def test_state_is_actually_sharded():
    e = _sharded("stream16", 8, chunk_steps=256, run=False)
    for name, x, axis in (("cycles", e.state.cycles, -1), ("dirm", e.state.dirm, -2),
                          ("events", e.events, -3), ("l1", e.state.l1, -2),
                          ("counters", e.state.counters, -1),
                          ("dram_free", e.state.dram_free, -1),
                          ("core_dead", e.state.faults.core_dead, -1)):
        assert isinstance(x, Shards) and x.axis == axis and len(x) == 8, name
        assert x.mesh.ids == list(range(8)), name
    assert e.state.dirm[0].shape[0] == e.cfg.llc.sets  # one bank of 8 a shard
    assert not isinstance(e.state.link_free, Shards)
    e.run()
    assert isinstance(e.state.cycles, Shards)  # still sharded after the run
    assert_engines_equal(_jax_run("stream16", 256), e)


def test_global_tile_mesh_single_process():
    info = process_info()
    assert info["process_count"] == 1 and info["global_devices"] == 8
    cfg, tr = _case("rw8")
    e = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=16, mesh=global_tile_mesh())
    e.run()
    assert_engines_equal(_jax_run("rw8", 16), e)


def test_sharded_parity_256core():
    assert_engines_equal(_jax_run("rw256"), _sharded("rw256", 8))


@pytest.mark.parametrize("case", list(MACHINES))
def test_sharded_machines(case):
    """MOESI, a torus, the coarse sharer vector, the router NoC with the
    DRAM queue, the prefetcher and O3, and a faulted machine (kills, link
    faults, ECC draws, DUE fail-stops) on 4 shards."""
    e = _sharded(case, 4, chunk_steps=32)
    assert_engines_equal(_jax_run(case, 32), e, case)
    if case == "faults":
        assert int(np.asarray(e.counters["core_failstops"]).sum()) >= 1


def test_sharded_step_never_moves_the_directory():
    """A 256-core, 256-bank chunk on 8 shards: every recorded move of
    directory rows carries at most C * (W1 + local_run_len + 2) rows,
    while a shard holds more; the probe's validation rows, the run's rows
    and the delta rows all move by request."""
    tcfg = port_cfg(dataclasses.replace(CFG256, llc=CacheConfig(
        size=16384, ways=4, line=64, latency=12)))
    tr = port_trace(synth.false_sharing(256, n_mem_ops=8, seed=94))
    C, W1, rl = tcfg.n_cores, tcfg.l1.ways, tcfg.local_run_len
    bound = C * (W1 + rl + 2)
    e = Engine(tcfg, tr, chunk_steps=4, mesh=sharding.tile_mesh(8))
    assert e.state.dirm[0].shape[0] > bound  # a whole shard would break it
    sharding.reset_moves()
    e.run_steps(4)
    DW = dirm_width(tcfg)
    rows = {}
    for name, m in sharding.MOVES.items():
        if m["shape"] and m["shape"][-1] == DW:
            rows[name] = int(np.prod(m["shape"][:-1]))
    assert {"probe.vrows", "probe.mrows", "commit.rows"} <= set(rows), sharding.MOVES
    assert max(rows.values()) <= bound, rows


# ---- the kernels' shard modes against the Pallas kernels --------------------


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 8])
def test_probe_staged_rows_matches_pallas(C, rl):
    """The staged-rows probe on a block of the cores (their global ids,
    the rows the Pallas kernel is staged) equals the Pallas kernel's
    outputs on that block."""
    jcfg, tcfg = _cfgs(C)
    arrs = _probe_inputs(jcfg, 300 + C + rl, rl)
    l1, dirm, slot, line, cid, step = arrs[:6]
    vrows, mrows = _stage(jcfg, l1, dirm, slot, line)
    j_out = j_probe(jcfg, l1, vrows, mrows, line, cid, step, *arrs[6:])
    lo, hi = C // 4, C // 2  # the second of four shards
    blk = [np.asarray(a)[lo:hi] for a in (l1, vrows, mrows, line)]
    DW = dirm_width(tcfg)
    patch = [torch.from_numpy(np.asarray(a)[lo:hi].copy())[None] for a in arrs[6:]]
    if rl:
        patch[0], patch[1] = patch[0] != 0, patch[1] != 0
    t_out = step_kernels.probe_classify_staged(
        tcfg, torch.from_numpy(blk[0])[None],
        torch.from_numpy(blk[1].reshape(hi - lo, -1, DW))[None],
        torch.from_numpy(blk[2])[None], torch.from_numpy(blk[3])[None],
        torch.arange(lo, hi, dtype=torch.int32),
        torch.from_numpy(np.asarray(step).reshape(1)), *patch)
    for n, a, b in zip(("tag", "lru", "weff", "shw", "vic_shw"), j_out[:5], t_out[:5]):
        np.testing.assert_array_equal(np.asarray(a)[lo:hi], b[0].numpy(), err_msg=n)
    np.testing.assert_array_equal(np.asarray(j_out[5])[lo:hi],
                                  t_out[5][0, :, :JAX_PROBE_LANES].numpy())
    # and it equals the whole-directory probe on the same cores
    whole = step_kernels.probe_classify(tcfg, *_bool_patch(
        [torch.from_numpy(np.array(a, copy=True)) for a in arrs], 6))
    for a, b in zip(whole, t_out):
        np.testing.assert_array_equal(a[lo:hi].numpy(), b[0].numpy())


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 8])
def test_commit_delta_rows_match_pallas(C, rl):
    """The delta-row commit on a block of the cores: its L1 rows and
    counters equal the Pallas kernel's on the block, its delta rows equal
    the Pallas kernel's where a winner or joiner adds (zeros elsewhere),
    and its target slots are the JAX engine's `upd_slot`."""
    jcfg, tcfg = _cfgs(C)
    arrs = _commit_inputs(jcfg, 400 + C + rl, rl)
    l1, dirm, tag_rows, shw, vic_shw, lanes, pc, cid, step, counters, delta = arrs[:11]
    NS = jcfg.n_banks * jcfg.llc.sets
    lanes[C - 1, [step_kernels.CL_WINNER, step_kernels.CL_JOIN]] = 0  # adds nothing
    j_l1, drow, j_cnt = j_commit(jcfg, l1, dirm[lanes[:, step_kernels.CL_SLOT]], tag_rows,
                                 shw, lanes, cid, step, counters, delta, *arrs[11:])
    lo, hi = C // 2, C
    t = [torch.from_numpy(np.array(a, copy=True)) for a in arrs]
    t = _bool_patch(t, 11)

    def blk(x, axis=0):
        return x.narrow(axis, lo, hi - lo).contiguous()[None]

    t_l1, t_cnt = blk(t[0]), blk(t[9], 1)
    rows, upd = step_kernels.commit_step_rows(
        tcfg, t_l1, blk(t[2]), blk(t[3]), blk(t[4]), blk(t[5]), blk(t[6]),
        t[7][lo:hi].contiguous(), t[8].reshape(1), t_cnt, blk(t[10], 1),
        *[blk(x) for x in t[11:]])
    np.testing.assert_array_equal(np.asarray(j_l1)[lo:hi], t_l1[0].numpy())
    np.testing.assert_array_equal(np.asarray(j_cnt)[:, lo:hi], t_cnt[0].numpy())
    wj = (lanes[lo:hi, step_kernels.CL_WINNER] != 0) | (lanes[lo:hi, step_kernels.CL_JOIN] != 0)
    assert wj.any() and not wj.all()
    np.testing.assert_array_equal(upd[0].numpy(), np.where(wj, lanes[lo:hi, step_kernels.CL_SLOT], NS))
    np.testing.assert_array_equal(rows[0].numpy()[wj], np.asarray(drow)[lo:hi][wj])
    assert not rows[0].numpy()[~wj].any()


@pytest.mark.parametrize("C", [8, 64])
def test_sharer_reductions_on_a_core_block(C):
    """The reductions on a block of the lanes with their global ids equal
    the whole launch's on those lanes: the sharer bits name every core."""
    jcfg, tcfg = _cfgs(C)
    rng = np.random.default_rng(500 + C)
    NW = tcfg.n_sharer_words
    words = rng.integers(0, 2**32, (2, C, NW), dtype=np.uint64).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(words[0]), torch.from_numpy(words[1]),
            torch.from_numpy(rng.integers(0, tcfg.n_tiles, C).astype(np.int32)),
            torch.from_numpy(rng.integers(-1, C, C).astype(np.int32)),
            torch.from_numpy(rng.random(C) < 0.6), torch.from_numpy(rng.random(C) < 0.6),
            torch.arange(C, dtype=torch.int32)]
    lat = [torch.tensor([2], dtype=torch.int32), torch.tensor([1], dtype=torch.int32)]
    whole = reductions.sharer_reductions(tcfg, *[a[None] for a in args[:6]], args[6], *lat)
    lo, hi = C // 4, C // 2
    part = reductions.sharer_reductions(
        tcfg, *[a[lo:hi].contiguous()[None] for a in args[:6]], args[6][lo:hi], *lat)
    assert any(int(x.sum()) for x in part)
    for a, b in zip(whole, part):
        np.testing.assert_array_equal(a[0, lo:hi].numpy(), b[0].numpy())


# ---- checkpoints, the chain, supervision ------------------------------------


def test_checkpoint_resume_multichip_mesh(tmp_path):
    """test_checkpoint.py:96, and across meshes: a snapshot taken on 8
    shards resumes on 8 (re-sharded), on 4, unsharded and in the JAX
    package, each equal to the uninterrupted JAX run."""
    cfg, tr = _case("fs8")
    ref = _jax_run("fs8", 8)
    a = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=8, mesh=sharding.tile_mesh(8))
    a.run_steps(16)
    ckpt = str(tmp_path / "mesh.npz")
    a.save_checkpoint(ckpt)
    for mesh in (sharding.tile_mesh(8), sharding.tile_mesh(4), None):
        b = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=8, mesh=mesh,
                   device="cpu" if mesh is None else None)
        b.load_checkpoint(ckpt)
        if mesh is not None:
            assert isinstance(b.state.cycles, Shards) and len(b.state.cycles) == mesh.size
        b.run()
        assert_engines_equal(ref, b, f"resumed on {mesh}")
    j = JEngine(cfg, tr, chunk_steps=8)
    j.load_checkpoint(ckpt)
    j.run()
    np.testing.assert_array_equal(np.asarray(j.cycles), np.asarray(ref.cycles))
    for k, v in ref.counters.items():
        np.testing.assert_array_equal(np.asarray(j.counters[k]), np.asarray(v), err_msg=k)


def test_chain_of_a_sharded_run_is_the_unsharded_jax_chain():
    """test_attest.py:79 for a solo run: the chain of an 8-shard run
    equals the unsharded JAX engine's, head for head (the state's leaves
    in JAX's order, gathered whole)."""
    from primesim_tpu.attest import SoloAttest as JSoloAttest
    from primesim_tpu_torch.attest import SoloAttest

    cfg, tr = _case("uniform_random")
    j = JEngine(cfg, tr, chunk_steps=32)
    j.attest = JSoloAttest(32)
    t = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=32, mesh=sharding.tile_mesh(8))
    t.attest = SoloAttest(32)
    heads = []
    while not (j.done() and t.done()):
        j.run_steps(32)
        t.run_steps(32)
        heads.append((j.attest.payload()["head"], t.attest.payload()["head"]))
    assert len(heads) > 2 and all(a == b for a, b in heads), heads
    assert j.attest.payload() == t.attest.payload()


def _revoke_plan(n=1, occurrence=2):
    return t_plan.FaultPlan(seed=0, events=(t_plan.FaultEvent(
        site="devices.revoke", occurrence=occurrence, action="revoke", args=(("n", n),)),))


def test_supervisor_reshards_after_device_revocation(tmp_path):
    """test_degrade.py:270: a seeded revocation at a chunk boundary; the
    supervisor re-places the newest verified snapshot on the largest
    valid smaller mesh and finishes bit-exact with the unsharded
    reference."""
    cfg, tr = _case("fft8")
    n = sharding.largest_valid_submesh(port_cfg(cfg), len(sharding.visible_devices("cpu")))
    mesh = sharding.tile_mesh(devices=sharding.visible_devices("cpu")[:n])
    eng = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=32, mesh=mesh)
    sup = RunSupervisor(eng, snapshot_dir=str(tmp_path / "snaps"),
                        checkpoint_every_chunks=1, handle_signals=False)
    t_sites.install(_revoke_plan(n=1, occurrence=2))
    sup.run()
    assert sup.degrade_rungs and sup.degrade_rungs[0].startswith(f"reshard:{n}->")
    assert sup.degrade_rungs == ["reshard:8->4"] and eng.mesh.ids == [0, 1, 2, 3]
    assert "degrade_rungs" in sup.summary()
    assert any("re-placed ckpt-" in ln for ln in sup.log_lines())
    assert_engines_equal(_jax_run("fft8", 32), eng)


def test_reshard_without_a_snapshot_re_places_the_live_state():
    """No snapshot directory: the rollback copy is re-laid on the smaller
    mesh; a revocation on one device takes nothing."""
    cfg, tr = _case("fft8")
    sharding.virtual_devices(4, "cpu")
    eng = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=32, mesh=sharding.tile_mesh(4))
    sup = RunSupervisor(eng, handle_signals=False)
    t_sites.install(_revoke_plan(n=3, occurrence=1))
    sup.run()
    assert sup.degrade_rungs == ["reshard:4->1"]
    assert any("re-placed live state" in ln for ln in sup.log_lines())
    assert_engines_equal(_jax_run("fft8", 32), eng)
    # one healthy device left and no mesh: the next revocation has nothing to take
    t_sites.install(_revoke_plan(n=1, occurrence=1))
    solo = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=32, device="cpu")
    sharding.virtual_devices(1, "cpu")
    s2 = RunSupervisor(solo, handle_signals=False)
    s2.run()
    assert s2.degrade_rungs == [] and s2.retries == 0


# ---- the CLI ------------------------------------------------------------------


def _main(args, capsys):
    rc = tcli.main(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_devices_runs_sharded(tmp_path, capsys):
    """test_cli.py:145: `run --devices 8` gives the single-device result,
    and the JAX CLI's mesh line."""
    cfg_path = str(tmp_path / "m.json")
    with open(cfg_path, "w") as f:
        f.write(MachineConfig(n_cores=16, n_banks=8).to_json())
    args = ["run", cfg_path, "--synth", "false_sharing:n_mem_ops=20",
            "--chunk-steps", "16", "--device", "cpu"]
    rc, out, _ = _main(args, capsys)
    single = json.loads(out)
    rc2, out2, err2 = _main(args + ["--devices", "8"], capsys)
    assert rc == rc2 == 0
    sharded = json.loads(out2)
    assert "mesh: 8 devices (cpu)" in err2
    for k in ("instructions", "max_core_cycles", "noc_msgs", "steps"):
        assert sharded["detail"][k] == single["detail"][k], k


def test_cli_devices_errors_exit_2_with_structured_json(capsys, tmp_path):
    """test_pod_scale.py:150: a bad N exits 2 with JAX's one-line
    DeviceMeshError, on the run and sweep paths and on the streamed,
    pooled and serving ones, which take --devices as JAX does; serve
    --devices without --pool-dir exits with JAX's text."""
    from primesim_tpu.cli import main as jmain

    cfg = os.path.join(REPO, "configs", "rung1_64core_fft.json")
    for args in (["run", cfg, "--synth", "fft_like", "--devices", "5"],
                 ["sweep", cfg, "--synth", "fft_like", "--devices", "48"],
                 ["run", cfg, "--synth", "fft_like", "--devices", "5", "--stream-window", "16"],
                 ["run", cfg, "--synth", "fft_like", "--devices", "16", "--stream-window", "16",
                  "--ingest-workers", "2"],
                 ["serve", cfg, "--devices", "5", "--state-dir", str(tmp_path / "s"),
                  "--pool-dir", str(tmp_path / "p")],
                 ["sweep", cfg, "--synth", "fft_like", "--devices", "48", "--workers", "2"]):
        rc, _, err = _main(args + ["--device", "cpu"], capsys)
        assert rc == 2, args
        obj = json.loads(err.strip().splitlines()[-1])
        assert jmain(args) == 2
        jerr = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        assert obj == jerr and obj["error"]["type"] == "DeviceMeshError"
    args = ["serve", cfg, "--devices", "2", "--state-dir", str(tmp_path / "unused")]
    with pytest.raises(SystemExit) as je:
        jmain(args)
    with pytest.raises(SystemExit) as te:
        tcli.main(args + ["--device", "cpu"])
    assert str(te.value) == str(je.value) and "--pool-dir" in str(te.value)


def _run_cli(args, n_devices, wait_snapshot_dir=None, kill=None, env_extra=None):
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env_extra or {}))
    proc = subprocess.Popen([sys.executable, "-m", "primesim_tpu_torch", *args, "--device", "cpu"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        if wait_snapshot_dir is not None:
            t_end = time.monotonic() + 240
            while time.monotonic() < t_end and proc.poll() is None:
                if os.path.isdir(wait_snapshot_dir) and any(
                        f.endswith(".npz") for f in os.listdir(wait_snapshot_dir)):
                    time.sleep(0.3)
                    break
                time.sleep(0.05)
            if proc.poll() is None:
                proc.send_signal(kill)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    return proc.returncode, out.decode(), err.decode()


def _run_summary(out):
    for ln in reversed(out.splitlines()):
        if ln.startswith("{"):
            det = json.loads(ln).get("detail") or {}
            if "instructions" in det:
                return det
    raise AssertionError("no run-summary JSON line in CLI output")


@pytest.mark.timeout(600)
def test_kill_8dev_resume_4dev_bit_exact(tmp_path):
    """test_degrade.py:390: an 8-shard supervised run is SIGKILLed after
    its first snapshot; a restart that sees 4 devices resumes it on 4
    shards and finishes with the unsharded reference's result, with
    --exec-cache and --attest chain riding along."""
    cfg_path = str(tmp_path / "m.json")
    with open(cfg_path, "w") as f:
        f.write(MachineConfig(n_cores=8, n_banks=8).to_json())
    spec = "fft_like:n_phases=3,points_per_core=48"
    ckdir = str(tmp_path / "ck")
    cache = {"PRIMETPU_CACHE_DIR": str(tmp_path / "cache")}
    base = ["run", cfg_path, "--synth", spec, "--chunk-steps", "8",
            "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
            "--exec-cache", "on", "--attest", "chain"]
    rc, out, err = _run_cli(base + ["--devices", "8"], 8, wait_snapshot_dir=ckdir,
                            kill=signal.SIGKILL, env_extra=cache)
    assert rc == -signal.SIGKILL, (rc, err[-2000:])
    rc, out, err = _run_cli(base + ["--devices", "4", "--resume"], 4, env_extra=cache)
    assert rc == 0, err[-2000:]
    resumed = _run_summary(out)
    assert resumed.get("resumed_from") and "mesh: 4 devices (cpu)" in err
    rc, out, err = _run_cli(["run", cfg_path, "--synth", spec, "--chunk-steps", "8"], 1)
    assert rc == 0, err[-2000:]
    ref = _run_summary(out)
    for k in ("instructions", "max_core_cycles", "noc_msgs", "steps"):
        assert resumed[k] == ref[k], k
