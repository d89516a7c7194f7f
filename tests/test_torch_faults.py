"""The port's fault injection (DESIGN.md §12) against the JAX package, on
the CPU.

Units, on numpy-seeded inputs through both packages: the counter-based
PRNG (against JAX and its numpy twin), the scheduled events with
duplicate and padding rows, the ECC draws with more banks than cores, the
dead-core scrub under both policies on a directory with bit-31 sharer
words, dead owners and a dead lock holder, and the link-detour leg
penalty on a mesh, a torus and a ring (against the scalar
`detour_stats`). Schedules load to the same configs and refuse the same
inputs with the same typed messages. Whole runs: the machines of
tests/test_faults.py, the torus and ring link-fault machines of
tests/test_zoo.py and a router machine with the DRAM queue and O3, each
through the port's `Engine(device="cpu")` and the JAX `Engine` once
(module-level cache): cycles, all 26 counters and every state field, the
fault state included. Then a faulted JAX state finished in the port, a
scheduled kill of a core that has already ended, a dead lock holder, and
the host's scrub trigger.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    FAULT_LINK_FAIL,
    CoreConfig,
    NocConfig,
    small_test_config,
)
from primesim_tpu.config.machine import FaultConfigError as JFaultConfigError
from primesim_tpu.faults import inject as j_inject
from primesim_tpu.faults import prng as j_prng
from primesim_tpu.faults import schedule as j_schedule
from primesim_tpu.noc import topology as j_topology
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import synth
from primesim_tpu_torch import convert
from primesim_tpu_torch.config.machine import FaultConfigError as TFaultConfigError
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.faults import inject as t_inject
from primesim_tpu_torch.faults import prng as t_prng
from primesim_tpu_torch.faults import schedule as t_schedule
from primesim_tpu_torch.noc import topology as t_topology
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim.state import llc_meta_width

from test_torch_engine import assert_engines_equal, jax_arrays, port_cfg, port_trace

FS, LF, LD = FAULT_CORE_FAILSTOP, FAULT_LINK_FAIL, FAULT_LINK_DEGRADE
FAULT_COUNTERS = ("core_failstops", "noc_reroutes", "ecc_corrected", "ecc_due")


def _cfg(**kw):
    return small_test_config(8, n_banks=4, quantum=200, **kw)


def _armed(cfg=None, **kw):
    kw.setdefault("max_fault_events", max(1, len(kw.get("fault_events", ()))))
    return dataclasses.replace(cfg or _cfg(), faults_enabled=True, **kw)


def _trace(n_mem_ops=96, seed=3):
    return synth.uniform_random(8, n_mem_ops=n_mem_ops, shared_frac=0.4, seed=seed)


def _zoo(topology):
    noc = NocConfig(mesh_x=4, mesh_y=4, link_lat=1, router_lat=2, topology=topology)
    return small_test_config(
        16, noc=noc, n_banks=4, quantum=400, faults_enabled=True,
        max_fault_events=2, fault_events=((5, LF, 0, 0), (8, LD, 22, 7)),
    )


def _router(**kw):
    noc = NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1,
                    contention=True, contention_model="router", contention_lat=2)
    return small_test_config(8, n_banks=4, quantum=400, noc=noc, dram_queue=True,
                             dram_service=8, core=CoreConfig(o3_overlap_256=64), **kw)


# ------------------------------------------------------------------ PRNG


@pytest.mark.parametrize("salt", [0, j_prng.DUE_SALT], ids=["draw", "due_salt"])
@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF])
def test_site_hash_matches_jax_and_its_numpy_twin(seed, salt):
    rng = np.random.default_rng(seed & 0xFFFF)
    steps = np.concatenate(
        [[0, 1, 2**31 - 2, 2**31 - 1], rng.integers(0, 2**31, 60)]).astype(np.int32)
    sites = np.concatenate(
        [np.arange(40), [2**16 - 1, 2**16, 32767, 2**31 - 1], rng.integers(0, 2**20, 60)]
    ).astype(np.int32)
    j = np.asarray(j_prng.site_hash(
        jnp.uint32(seed), jnp.asarray(steps)[:, None], jnp.asarray(sites)[None, :], salt))
    t = t_prng.site_hash(
        torch.tensor(seed, dtype=torch.int64), torch.from_numpy(steps)[:, None],
        torch.from_numpy(sites)[None, :], salt).numpy()
    h = j_prng.site_hash_np(seed, steps[:, None], sites[None, :], salt)
    assert t.dtype == np.int64 and t.min() >= 0 and t.max() < 2**32
    np.testing.assert_array_equal(t, j.astype(np.int64))
    np.testing.assert_array_equal(t, h.astype(np.int64))
    np.testing.assert_array_equal(
        t_prng.site_hash_np(seed, steps[:, None], sites[None, :], salt), h)
    # the engine's step is an int32 scalar tensor
    one = t_prng.site_hash(torch.tensor(seed, dtype=torch.int64),
                           torch.tensor(2**31 - 1, dtype=torch.int32),
                           torch.from_numpy(sites), salt).numpy()
    np.testing.assert_array_equal(one, h[3])


@pytest.mark.parametrize("p", [0.0, 1e-9, 1.0])
def test_prob_threshold_and_the_unsigned_compare(p):
    thr = t_prng.prob_threshold(p)
    assert int(thr) == int(j_prng.prob_threshold(p))
    assert int(thr) == {0.0: 0, 1e-9: 4, 1.0: 0xFFFFFFFF}[p]
    h = np.array([0, 1, 3, 4, 2**31 - 1, 2**31, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    got = torch.from_numpy(h.astype(np.int64)) < torch.tensor(int(thr), dtype=torch.int64)
    np.testing.assert_array_equal(got.numpy(), h < thr)


# ----------------------------------------------------------------- units


def _fault_states(jcfg, **arrays):
    """The same FaultState in both packages: the config's, with `arrays`
    (numpy) in place of its fields."""
    j = j_schedule.fault_state_from_config(jcfg)._replace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    t = t_schedule.fault_state_from_config(port_cfg(jcfg), "cpu")
    t = t._replace(**{k: torch.from_numpy(np.asarray(v)).to(getattr(t, k).dtype)
                      for k, v in arrays.items()})
    return j, t


def test_fire_events_max_duplicates_and_drop_padding():
    C, NL = 8, 16
    events = ((3, LF, 5, 0), (3, LF, 5, 0), (3, LD, 6, 4), (3, LD, 6, 9),
              (3, LD, 5, 2), (3, FS, 2, 0), (3, FS, 2, 0), (7, FS, C - 1, 0),
              (7, LF, NL - 1, 0), (7, LD, 6, 1))
    jcfg = _armed(fault_events=events, max_fault_events=16)  # 6 padding rows
    rng = np.random.default_rng(11)
    jfs, tfs = _fault_states(
        jcfg, link_dead=(rng.random(NL) < 0.2).astype(np.int32),
        link_extra=rng.integers(0, 8, NL).astype(np.int32))
    assert int((np.asarray(jfs.ev_step) == -1).sum()) == 6
    out = {}
    for step_no in (0, 3, 7, 8):
        j = j_inject.fire_events(jcfg, jfs, jnp.int32(step_no))
        t = out[step_no] = t_inject.fire_events(
            port_cfg(jcfg), tfs, torch.tensor(step_no, dtype=torch.int32))
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"step {step_no}")
    kill, dead, extra = out[7]
    assert int(kill[C - 1]) == 1 and int(dead[NL - 1]) == 1 and int(extra[6]) >= 1
    kill, dead, extra = out[3]
    assert int(kill.sum()) == 1 and int(dead[5]) == 1 and int(extra[6]) >= 9


def test_ecc_step_with_more_banks_than_cores():
    jcfg = _armed(small_test_config(4, n_banks=16, quantum=200), fault_flip_l1=0.5,
                  fault_flip_llc=0.6, fault_due_rate=0.4, fault_seed=0xFFFFFFFF)
    jfs, tfs = _fault_states(jcfg)
    tot = np.zeros(2, np.int64)
    for step_no in [*range(24), 2**31 - 1]:
        j = j_inject.ecc_step(jcfg, jfs, jnp.int32(step_no), jnp.arange(4, dtype=jnp.int32))
        t = t_inject.ecc_step(port_cfg(jcfg), tfs, torch.tensor(step_no, dtype=torch.int32))
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"step {step_no}")
        tot += [int(t[0].sum()), int(t[1].sum())]
    assert (tot > 0).all() and int(t[0].max()) >= 0


@pytest.mark.parametrize("policy", ["writeback", "drop"])
def test_scrub_dead_in_place_equals_jax(policy):
    C = 40  # two sharer words, padding bits in the second
    jcfg = dataclasses.replace(small_test_config(C, n_banks=4), fault_dead_policy=policy)
    tcfg = port_cfg(jcfg)
    W2, NW, MW = jcfg.llc.ways, jcfg.n_sharer_words, llc_meta_width(tcfg)
    R = jcfg.n_banks * jcfg.llc.sets
    rng = np.random.default_rng(5)
    dirm = np.zeros((R, MW + W2 * NW), np.int32)
    dirm[:, 0 : 2 * W2 : 2] = rng.integers(-1, 50, (R, W2))
    dirm[:, 1 : 2 * W2 : 2] = rng.integers(-1, C, (R, W2))
    dirm[:, 2 * W2 : 4 * W2] = rng.integers(0, 9, (R, 2 * W2))
    dirm[:, MW:] = rng.integers(0, 2**32, (R, W2 * NW), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    lock_holder = np.array([-1, 31, 3, 39, 31, 0, -1, 7], np.int32)
    for killed in ([31, 39, 3], [], [0, 17]):
        kill = np.zeros(C, np.int32)
        kill[killed] = 1
        jd, jl, jwb = j_inject.scrub_dead(jcfg, jnp.asarray(dirm), jnp.asarray(lock_holder),
                                          jnp.asarray(kill != 0))
        td = torch.from_numpy(dirm.copy())
        tl, twb = t_inject.scrub_dead(tcfg, td, torch.from_numpy(lock_holder),
                                      torch.from_numpy(kill))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=str(killed))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(twb.numpy(), np.asarray(jwb))
        if not killed:  # the identity: what a candidate step with no kill runs
            np.testing.assert_array_equal(td.numpy(), dirm)
            assert not twb.any()
    own = dirm[:, 1 : 2 * W2 : 2]
    assert (own == 31).any() and (dirm[:, MW:] < 0).any()  # dead owners, bit 31


@pytest.mark.parametrize(
    "topology,mx,my", [("mesh", 4, 4), ("torus", 4, 4), ("ring", 5, 3)])
def test_leg_fault_penalty_equals_jax_and_detour_stats(topology, mx, my):
    noc = NocConfig(mesh_x=mx, mesh_y=my, link_lat=1, router_lat=2, topology=topology)
    jcfg = _armed(small_test_config(mx * my, n_banks=4, noc=noc))
    tcfg = port_cfg(jcfg)
    np.testing.assert_array_equal(t_topology.detour_hops_table(tcfg),
                                  j_topology.detour_hops_table(jcfg))
    nl = jcfg.n_tiles * 4
    rng = np.random.default_rng(7)
    link_dead = (rng.random(nl) < 0.2).astype(np.int32)
    link_extra = rng.integers(0, 6, nl).astype(np.int32)
    jfs, tfs = _fault_states(jcfg, link_dead=link_dead, link_extra=link_extra)
    tiles = np.arange(jcfg.n_tiles, dtype=np.int32)
    a, b = np.repeat(tiles, jcfg.n_tiles), np.tile(tiles, jcfg.n_tiles)
    jkn = SimpleNamespace(link_lat=jnp.int32(1), router_lat=jnp.int32(2))
    tkn = SimpleNamespace(link_lat=torch.tensor(1, dtype=torch.int32),
                          router_lat=torch.tensor(2, dtype=torch.int32))
    j = j_inject.leg_fault_penalty(jcfg, jfs, jkn, jnp.asarray(a), jnp.asarray(b))
    t = t_inject.leg_fault_penalty(tcfg, tfs, tkn, torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(j, t):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    lat, hops, rer = (y.numpy() for y in t)
    for i in range(a.size):
        ref = t_topology.detour_stats(tcfg, int(a[i]), int(b[i]), link_dead, link_extra, 1, 2)
        assert (int(lat[i]), int(hops[i]), int(rer[i])) == ref, (a[i], b[i])
        assert ref == j_topology.detour_stats(jcfg, int(a[i]), int(b[i]), link_dead,
                                              link_extra, 1, 2)
    assert rer.any() and (lat > 0).sum() > rer.sum()  # detours and degrades


# ------------------------------------------------------------- schedules


def test_schedules_load_and_apply_as_in_jax(tmp_path):
    d = {"events": [{"step": 4, "kind": "core_failstop", "core": 2},
                    {"step": 9, "kind": "link_degrade", "link": 1, "extra": 3},
                    {"step": 9, "kind": "link_fail", "link": 2}],
         "flip_l1": 1e-6, "flip_llc": 1e-3, "due_rate": 0.25,
         "due_failstop": True, "dead_policy": "drop"}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(d))
    js, ts = j_schedule.load_schedule(str(path)), t_schedule.load_schedule(str(path))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for empty in ({}, {"events": []}):
        assert (dataclasses.asdict(t_schedule.schedule_from_dict(empty))
                == dataclasses.asdict(j_schedule.schedule_from_dict(empty)))
    base = _cfg()
    for sched_t, sched_j in ((ts, js), (t_schedule.FaultSchedule(), j_schedule.FaultSchedule())):
        got = sched_t.apply(port_cfg(base), seed=3)
        assert got.to_json() == sched_j.apply(base, seed=3).to_json()
    assert ts.apply(port_cfg(base)).max_fault_events == 4  # 3 events, a power of two
    # the committed headline schedule is the full-width fixture's machine
    import test_torch_rules as rules

    sched = t_schedule.load_schedule(
        rules.PKG + "/fixtures/headline_faults_schedule.json")
    assert (sched.apply(TCfg.from_dict(rules.HEADLINE), seed=7).to_json()
            == TCfg.from_dict(rules.HEADLINE_FAULTS).to_json())


def _errors(make):
    """The typed error each package raises for the same bad input."""
    out = []
    for exc, pkg in ((JFaultConfigError, "jax"), (TFaultConfigError, "torch")):
        with pytest.raises(exc) as ei:
            make(pkg)
        out.append((str(ei.value), ei.value.location()))
    return out


BAD_CONFIGS = {
    "core_out_of_range": dict(fault_events=((5, FS, 99, 0),)),
    "negative_step": dict(fault_events=((-2, FS, 1, 0),)),
    "unknown_kind": dict(fault_events=((1, 77, 0, 0),)),
    "link_out_of_range": dict(fault_events=((1, LF, 10_000, 0),)),
    "flip_above_one": dict(fault_flip_l1=1.5),
    "negative_due_rate": dict(fault_due_rate=-0.1),
    "bad_policy": dict(fault_dead_policy="shrug"),
    "over_capacity": dict(fault_events=((1, FS, 0, 0),) * 3, max_fault_events=2),
}
BAD_SCHEDULES = {
    "unknown_kind": {"events": [{"step": 1, "kind": "meteor"}]},
    "missing_step": {"events": [{"kind": "link_fail", "link": 0}]},
    "unknown_field": {"evnets": []},
    "event_not_object": {"events": [3]},
    "missing_core": {"events": [{"step": 2, "kind": "core_failstop"}]},
    "missing_link": {"events": [{"step": 2, "kind": "link_degrade", "extra": 1}]},
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_bad_fault_configs_raise_the_jax_error(name):
    kw = BAD_CONFIGS[name]
    jpair, tpair = _errors(lambda pkg: _armed(
        _cfg() if pkg == "jax" else port_cfg(_cfg()), **kw))
    assert tpair == jpair


def test_failstop_requires_an_exact_directory():
    def make(pkg):
        cfg = small_test_config(64, sharer_group=8)
        cfg = cfg if pkg == "jax" else port_cfg(cfg)
        dataclasses.replace(cfg, faults_enabled=True, max_fault_events=1,
                            fault_events=((1, FS, 0, 0),))
    jpair, tpair = _errors(make)
    assert tpair == jpair


@pytest.mark.parametrize("name", [*sorted(BAD_SCHEDULES), "not_json", "not_an_object"])
def test_bad_schedules_raise_the_jax_error(name, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text({"not_json": "{not json", "not_an_object": "[1, 2]"}.get(
        name, json.dumps(BAD_SCHEDULES.get(name))))
    jpair, tpair = _errors(lambda pkg: (
        j_schedule if pkg == "jax" else t_schedule).load_schedule(str(path)))
    assert tpair == jpair


# ------------------------------------------------------------ whole runs


def _lock_holder_kill():
    """lock_contention(8) with a core killed at a step where it holds a
    lock, found from a faults-off dry run of the port."""
    cfg, tr = _armed(fault_events=((0, LF, 0, 0),)), synth.lock_contention(8, n_critical=6)
    dry = port_cfg(cfg)  # the kill changes nothing before its step
    st = t_engine.init_state(dry, "cpu")
    events = torch.from_numpy(tr.line_events(cfg.line_bits))
    for s in range(400):
        held = [(int(h), i) for i, h in enumerate(st.lock_holder) if int(h) >= 0]
        if s >= 20 and held:
            core, slot = held[0]
            return _armed(fault_events=((0, LF, 0, 0), (s, FS, core, 0)),
                          max_fault_events=2), tr, (s, core, slot)
        st = t_engine.step(dry, events, st)
    raise AssertionError("no core held a lock")


def _ended_core_kill():
    """uniform_random(8) with a scheduled kill of a core five steps after
    it reached END, found from a faults-off dry run of the port."""
    tr = synth.uniform_random(8, n_mem_ops=24, shared_frac=0.4, seed=9)
    tr.events[5, 16:] = tr.events[5, tr.lengths[5] - 1]  # core 5 ends early
    tr.lengths[5] = 17
    off = port_cfg(_cfg())
    st = t_engine.init_state(off, "cpu")
    events = torch.from_numpy(tr.line_events(off.line_bits))
    for s in range(400):
        if int(st.ptr[5]) >= 16:
            return _armed(fault_events=((s + 5, FS, 5, 0),)), tr, s + 5
        st = t_engine.step(off, events, st)
    raise AssertionError("core 5 never ended")


MACHINES = {
    "faults_off": (_cfg(), _trace()),
    "empty_schedule": (_armed(fault_seed=7), _trace()),
    "failstop": (_armed(fault_events=((5, FS, 3, 0),)), _trace()),
    "failstop_barrier": (_armed(fault_events=((2, FS, 6, 0),)),
                         synth.barrier_phases(8, n_phases=3, work_per_phase=8, seed=5)),
    "writeback": (_armed(fault_events=((20, FS, 2, 0),), fault_dead_policy="writeback"),
                  _trace(128)),
    "drop": (_armed(fault_events=((20, FS, 2, 0),), fault_dead_policy="drop"), _trace(128)),
    "link_fail": (_armed(fault_events=((0, LF, 0, 0),)), _trace(128)),
    "link_degrade": (_armed(fault_events=((0, LD, 0, 9),)), _trace(128)),
    "ecc_corrected": (_armed(fault_flip_l1=1.0, fault_flip_llc=1.0, fault_seed=9), _trace()),
    "ecc_due": (_armed(fault_flip_l1=1.0, fault_due_rate=0.5, fault_seed=1), _trace()),
    "due_failstop": (_armed(fault_flip_l1=1.0, fault_due_rate=1.0, fault_due_failstop=True,
                            fault_seed=2), _trace()),
    "due_failstop_sparse": (_armed(fault_flip_l1=0.004, fault_due_rate=0.5,
                                   fault_due_failstop=True, fault_seed=4,
                                   fault_dead_policy="drop"), _trace(128)),
    "torus_links": (_zoo("torus"), synth.uniform_random(16, n_mem_ops=96, shared_frac=0.4,
                                                        seed=13)),
    "ring_links": (_zoo("ring"), synth.uniform_random(16, n_mem_ops=96, shared_frac=0.4,
                                                      seed=13)),
    "router_dram_o3": (_router(faults_enabled=True, max_fault_events=4, fault_seed=7,
                               fault_events=((0, LF, 0, 0), (0, LD, 2, 5), (4, FS, 3, 0)),
                               fault_flip_llc=0.3, fault_due_rate=0.3),
                       synth.barrier_phases(8, n_phases=3, work_per_phase=8, seed=5)),
}
_CACHE = {}


def runs(name):
    """(JAX engine, port engine) of a machine, each run once to the end."""
    if name not in _CACHE:
        if name == "lock_holder":
            cfg, tr, info = _lock_holder_kill()
        elif name == "ended_core":
            cfg, tr, info = _ended_core_kill()
        else:
            (cfg, tr), info = MACHINES[name], None
        je = JEngine(cfg, tr, chunk_steps=32)
        je.run()
        te = t_engine.Engine(port_cfg(cfg), port_trace(tr), 32, device="cpu")
        te.run()
        _CACHE[name] = je, te, info
    return _CACHE[name]


@pytest.mark.parametrize("name", [*MACHINES, "lock_holder", "ended_core"])
def test_whole_run_equals_jax(name):
    je, te, _ = runs(name)
    assert_engines_equal(je, te, name)
    assert te.done()
    np.testing.assert_array_equal(te.done_mask(), je.done_mask())
    te.verify_invariants()


def test_fault_counters_and_effects():
    def sums(name, k):
        return int(runs(name)[1].counters[k].sum())

    off, empty = runs("faults_off")[1], runs("empty_schedule")[1]
    np.testing.assert_array_equal(empty.cycles, off.cycles)
    for f in ("l1", "dirm"):
        assert torch.equal(getattr(empty.state, f), getattr(off.state, f))
    assert all(sums("empty_schedule", k) == 0 for k in FAULT_COUNTERS)
    assert runs("failstop")[1].counters["core_failstops"][3] == 1
    assert sums("failstop_barrier", "core_failstops") == 1
    assert sums("writeback", "l1_writebacks") >= sums("drop", "l1_writebacks")
    assert sums("link_fail", "noc_reroutes") > 0 and sums("link_degrade", "noc_reroutes") == 0
    np.testing.assert_array_equal(runs("ecc_corrected")[1].cycles, runs("faults_off")[1].cycles)
    assert sums("ecc_corrected", "ecc_corrected") > 0 and sums("ecc_corrected", "ecc_due") == 0
    assert sums("ecc_due", "ecc_due") > 0 and sums("ecc_due", "core_failstops") == 0
    assert sums("due_failstop", "core_failstops") == 8
    assert 0 < sums("due_failstop_sparse", "core_failstops") < 8
    for name in ("torus_links", "ring_links", "router_dram_o3"):
        assert sums(name, "noc_reroutes") > 0, name
    assert sums("router_dram_o3", "noc_contention_cycles") > 0
    assert sums("router_dram_o3", "ecc_due") > 0
    assert sums("ended_core", "core_failstops") == 0  # it had ended: no kill


def test_a_dead_lock_holder_releases_its_lock():
    je, te, (s, core, slot) = runs("lock_holder")
    assert int(te.counters["core_failstops"][core]) == 1
    cfg = port_cfg(je.cfg)
    eng = t_engine.Engine(cfg, port_trace(synth.lock_contention(8, n_critical=6)), s,
                          device="cpu")
    eng.run_steps(s)
    assert int(eng.state.lock_holder[slot]) == core  # holds it at the kill step
    eng.run_steps(1)
    assert int(eng.state.lock_holder[slot]) != core


def test_scrub_runs_only_where_a_core_can_die(monkeypatch):
    """The engine runs the whole-directory scrub on the steps the host's
    `kill_possible` names (a scheduled fail-stop, or an L1 DUE draw under
    due_failstop), not on every step."""
    calls = []
    real = t_inject.scrub_dead

    def counted(cfg, dirm, lock_holder, kill_now):
        calls.append(int(kill_now.sum()))
        return real(cfg, dirm, lock_holder, kill_now)

    monkeypatch.setattr(t_inject, "scrub_dead", counted)
    for name, want in (("failstop", [1]), ("ended_core", [0])):
        cfg, tr, _ = (*MACHINES[name], None) if name in MACHINES else _ended_core_kill()
        calls.clear()
        eng = t_engine.Engine(port_cfg(cfg), port_trace(tr), 32, device="cpu")
        eng.run()
        assert calls == want, name
    cfg, tr = MACHINES["due_failstop_sparse"]
    calls.clear()
    eng = t_engine.Engine(port_cfg(cfg), port_trace(tr), 32, device="cpu")
    eng.run()
    fs = eng.state.faults
    host = {k: getattr(fs, k).numpy() for k in ("seed", "ev_step", "ev_kind", "flip_l1",
                                                 "due_rate")}
    n_cand = int(t_inject.kill_possible(eng.cfg, host, np.arange(eng.steps_run)).sum())
    assert len(calls) == n_cand < eng.steps_run
    assert sum(calls) == int(eng.counters["core_failstops"].sum()) > 0


def test_a_faulted_jax_state_finishes_in_the_port():
    cfg = _armed(fault_events=((5, FS, 3, 0), (8, LF, 0, 0)), fault_flip_l1=0.3,
                 fault_due_rate=0.3, fault_due_failstop=True, fault_seed=5,
                 max_fault_events=2)
    tr = _trace(128)
    je = JEngine(cfg, tr, chunk_steps=8)
    je.run_steps(16)
    assert not je.done() and int(np.asarray(je.state.faults.core_dead).sum()) >= 1
    before = {k: v.copy() for k, v in je.counters.items()}  # drains the JAX state
    te = t_engine.Engine(port_cfg(cfg), port_trace(tr), 8, device="cpu")
    te.state = convert.state_from_numpy(te.cfg, jax_arrays(je.state), "cpu")
    te.cycle_base, te.steps_run = int(je.cycle_base), je.steps_run
    te.host_counters = {k: v.copy() for k, v in before.items()}
    je.run()
    te.run()
    assert_engines_equal(je, te, "finished in the port")
