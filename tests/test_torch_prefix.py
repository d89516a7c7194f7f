"""The port's prefix forking and warm-state cache (`primesim_tpu_torch/
sim/prefix.py`, `FleetEngine.fork_element`, the warm cache of
`sim/checkpoint.py`) against the JAX package, on the CPU.

The machines are tests/test_prefix.py's: `small_test_config(8,
n_banks=4, quantum=200)` armed with one link degrade at step 40 (the
divergence point of a seed sweep), `fft_like(8, 2 phases, 12 points)`, in
chunks of 16, so the fork lands at step 32. The planner gives the JAX
package's groups; a forked sweep equals the unforked port fleet and the
JAX fleet in cycles, every counter and every state field; `warm_key` is
the JAX key letter for letter, and warm entries written by either
package load in the other. Each JAX reference runs once per module.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import functools
import json
import os
import shutil
import signal

import numpy as np
import pytest

from primesim_tpu.config.machine import FAULT_LINK_DEGRADE, MachineConfig, small_test_config
from primesim_tpu.sim import prefix as j_prefix
from primesim_tpu.sim.checkpoint import trace_fingerprint as j_fp
from primesim_tpu.sim.checkpoint import warm_key as j_warm_key
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.fleet import FleetEngine as JFleet
from primesim_tpu.sim.fleet import apply_overrides as j_apply
from primesim_tpu.sim.supervisor import RunSupervisor as JSupervisor
from primesim_tpu.trace import synth
from primesim_tpu_torch.obs import Recorder
from primesim_tpu_torch.sim import checkpoint as t_ck
from primesim_tpu_torch.sim import prefix as t_prefix
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.sim.fleet import FleetEngine
from primesim_tpu_torch.sim.fleet import apply_overrides as t_apply
from primesim_tpu_torch.sim.supervisor import Preempted, RunSupervisor
from primesim_tpu_torch.util import diskpressure as t_dp

from test_torch_engine import assert_engines_equal, port_cfg, port_trace
from test_torch_fleet import assert_fleets_equal

EV_STEP = 40  # fault-schedule start: the divergence point of a seed sweep
CHUNK = 16
PREFIX = EV_STEP // CHUNK * CHUNK  # chunk-floored fork point (32)


@pytest.fixture(autouse=True)
def _clean_disk_governance(tmp_path, monkeypatch):
    monkeypatch.setenv("PRIMETPU_CACHE_DIR", str(tmp_path / "cache"))
    t_dp.configure(None)
    t_dp._EVICTORS.clear()
    t_dp._COMPACTORS.clear()
    yield
    t_dp.configure(None)
    t_dp._EVICTORS.clear()
    t_dp._COMPACTORS.clear()


def _chaos_cfg(**kw):
    cfg = small_test_config(8, n_banks=4, quantum=200, **kw)
    return dataclasses.replace(
        cfg, faults_enabled=True, max_fault_events=1,
        fault_events=((EV_STEP, FAULT_LINK_DEGRADE, 0, 3),),
    )


def _trace(seed=41):
    return synth.fft_like(8, n_phases=2, points_per_core=12, seed=seed)


def _seed_ovs(n):
    return [{"fault_seed": 100 + i} for i in range(n)]


MIXED_TRACES = (41, 41, 99, 99, 41)
MIXED_OVS = [{"fault_seed": 1}, {"fault_seed": 2}, {"fault_seed": 3},
             {"fault_seed": 4}, {"fault_seed": 5, "dram_lat": 250}]


def _tfleet(cfg, traces, ovs):
    return FleetEngine(port_cfg(cfg), [port_trace(t) for t in traces], ovs,
                       chunk_steps=CHUNK, device="cpu")


def _seed_fleet(n=4, cfg=None):
    return _tfleet(cfg or _chaos_cfg(), [_trace()] * n, _seed_ovs(n))


@functools.lru_cache(maxsize=None)
def jax_fleet(name):
    """The JAX package's unforked fleet, run to the end."""
    if name == "mixed":
        fl = JFleet(_chaos_cfg(), [_trace(s) for s in MIXED_TRACES], MIXED_OVS,
                    chunk_steps=CHUNK)
    else:
        n = int(name)
        fl = JFleet(_chaos_cfg(), [_trace()] * n, _seed_ovs(n), chunk_steps=CHUNK)
    fl.run()
    return fl


def _plan(fleet, **kw):
    return t_prefix.plan_prefix(fleet.elem_cfgs, fleet.traces, chunk_steps=CHUNK, **kw)


def _groups(groups):
    return [(g.indices, g.divergence, g.prefix_steps) for g in groups]


# ---- divergence analysis ----------------------------------------------------


def test_group_divergence_gives_the_jax_steps():
    cfg = _chaos_cfg()
    a = dataclasses.replace(cfg, fault_seed=1)
    b = dataclasses.replace(cfg, fault_seed=2)
    c = dataclasses.replace(cfg, max_fault_events=2, fault_events=cfg.fault_events
                            + ((77, FAULT_LINK_DEGRADE, 1, 2),))
    d = dataclasses.replace(b, fault_events=())
    for cfgs, want in (([cfg, cfg], t_prefix.NEVER), ([a, b], EV_STEP),
                       ([cfg, c], 77), ([a, d], EV_STEP), ([d, d], t_prefix.NEVER)):
        assert t_prefix.group_divergence([port_cfg(x) for x in cfgs]) == want
        assert j_prefix.group_divergence(cfgs) == want
    assert t_prefix.NEVER == j_prefix.NEVER


PLANS = {
    "seed_sweep": (_chaos_cfg, [41] * 4, _seed_ovs(4), {}),
    "mixed": (_chaos_cfg, list(MIXED_TRACES), MIXED_OVS, {}),
    "classes": (_chaos_cfg, [41, 41, 99, 99, 41, 41],
                [{"fault_seed": 1}, {"fault_seed": 2}, {"fault_seed": 3},
                 {"fault_seed": 4}, {"fault_seed": 5, "dram_lat": 200},
                 {"fault_seed": 6, "llc_lat": 20}], {}),
    "live_seed": (lambda: dataclasses.replace(_chaos_cfg(), fault_flip_l1=0.25),
                  [41] * 4, _seed_ovs(4), {}),
    "off": (_chaos_cfg, [41] * 4, _seed_ovs(4), {"mode": "off"}),
    "capped": (_chaos_cfg, [41] * 4, _seed_ovs(4), {"mode": "16"}),
    "zero_cap": (_chaos_cfg, [41] * 4, _seed_ovs(4), {"mode": "0"}),
    "budget": (_chaos_cfg, [41] * 4, _seed_ovs(4), {"cap": 20}),
    "identical": (_chaos_cfg, [41] * 3, [{}] * 3, {}),
    "identical_capped": (_chaos_cfg, [41] * 3, [{}] * 3, {"cap": 48}),
}


@pytest.mark.parametrize("name", PLANS)
def test_plan_prefix_gives_the_jax_groups(name):
    mk, seeds, ovs, kw = PLANS[name]
    cfg = mk()
    traces = [_trace(s) for s in seeds]
    want = j_prefix.plan_prefix([j_apply(cfg, o) for o in ovs], traces,
                                chunk_steps=CHUNK, **kw)
    got = t_prefix.plan_prefix([t_apply(port_cfg(cfg), o) for o in ovs],
                               [port_trace(t) for t in traces], chunk_steps=CHUNK, **kw)
    assert _groups(got) == _groups(want)
    if name == "seed_sweep":
        assert _groups(got) == [([0, 1, 2, 3], EV_STEP, PREFIX)]
    if name == "mixed":
        assert [g[0] for g in _groups(got)] == [[0, 1], [2, 3]]


def test_dedup_plan_gives_the_jax_plan():
    cfg = _chaos_cfg()
    tr, other = _trace(), _trace(99)
    ovs = [{"fault_seed": 1}, {"fault_seed": 1}, {"fault_seed": 2}, {"fault_seed": 1}]
    traces = [tr, tr, tr, other]
    got = t_prefix.dedup_plan([t_apply(port_cfg(cfg), o) for o in ovs],
                              [port_trace(t) for t in traces])
    assert got == j_prefix.dedup_plan([j_apply(cfg, o) for o in ovs], traces)
    assert got == ([0, 2, 3], {1: 0})


# ---- fork-from-snapshot bit-exactness ---------------------------------------


def test_forked_seed_sweep_equals_unforked_and_jax():
    ref = jax_fleet("16")
    assert int(ref.steps_run.max()) > EV_STEP  # the schedule fires mid-run

    fleet = _seed_fleet(16)
    groups = _plan(fleet)
    assert len(groups) == 1 and groups[0].indices == list(range(16))
    st = t_prefix.execute_prefix_plan(fleet, groups)
    assert (st["forked_elements"], st["prefix_steps"], st["groups"]) == (16, PREFIX, 1)
    assert (st["cache_hits"], st["cache_misses"]) == (0, 0)
    assert list(fleet.prefix_steps) == [PREFIX] * 16
    assert list(fleet.steps_run) == [PREFIX] * 16
    fleet.run()
    assert_fleets_equal(ref, fleet)

    unforked = _seed_fleet(16)
    unforked.run()
    assert_fleets_equal(ref, unforked)
    assert list(unforked.prefix_steps) == [0] * 16

    # and element 3 against a solo port Engine of its effective config
    solo = Engine(fleet.elem_cfgs[3], fleet.traces[3], chunk_steps=CHUNK, device="cpu")
    solo.run()
    np.testing.assert_array_equal(fleet.cycles[3], solo.cycles)
    fc = fleet.element_counters(3)
    for k, v in solo.counters.items():
        np.testing.assert_array_equal(fc[k], v, err_msg=k)
    es = fleet.element_state(3)
    for f in ("l1", "dirm"):
        assert (getattr(es, f) == getattr(solo.state, f)).all(), f


def test_forked_mixed_groups_and_singletons_equal_jax():
    fleet = _tfleet(_chaos_cfg(), [_trace(s) for s in MIXED_TRACES], MIXED_OVS)
    groups = _plan(fleet)
    assert [g.indices for g in groups] == [[0, 1], [2, 3]]
    st = t_prefix.execute_prefix_plan(fleet, groups)
    assert st["groups"] == 2 and st["forked_elements"] == 4
    assert list(fleet.prefix_steps) == [PREFIX, PREFIX, PREFIX, PREFIX, 0]
    assert fleet.prefix_cache_keys[0] == fleet.prefix_cache_keys[1] != fleet.prefix_cache_keys[2]
    assert fleet.prefix_cache_keys[4] is None
    fleet.run()
    assert_fleets_equal(jax_fleet("mixed"), fleet)


# ---- the warm-state cache ---------------------------------------------------

KEYS = {
    "base": lambda c: (c, 41, PREFIX),
    "other_trace": lambda c: (c, 99, PREFIX),
    "geometry": lambda c: (dataclasses.replace(
        c, llc=dataclasses.replace(c.llc, size=c.llc.size * 2)), 41, PREFIX),
    "knob": lambda c: (j_apply(c, {"dram_lat": 200}), 41, PREFIX),
    "steps": lambda c: (c, 41, PREFIX + CHUNK),
    "seed_rates0": lambda c: (dataclasses.replace(c, fault_seed=7), 41, PREFIX),
    "ecc": lambda c: (dataclasses.replace(c, fault_flip_l1=0.25), 41, PREFIX),
    "ecc_seed": lambda c: (dataclasses.replace(c, fault_flip_l1=0.25, fault_seed=7),
                           41, PREFIX),
    "late_event": lambda c: (dataclasses.replace(
        c, fault_events=((EV_STEP + 100, FAULT_LINK_DEGRADE, 0, 3),)), 41, PREFIX),
    "no_events": lambda c: (dataclasses.replace(c, fault_events=()), 41, PREFIX),
    "past_event": lambda c: (c, 41, 64),
    "cpi_vector": lambda c: (j_apply(c, {"cpi": [1, 2, 3, 4, 1, 2, 3, 4]}), 41, PREFIX),
}


@pytest.mark.parametrize("name", KEYS)
def test_warm_key_is_the_jax_key(name):
    cfg, seed, steps = KEYS[name](_chaos_cfg())
    tr = _trace(seed)
    fp = j_fp(tr)
    assert t_ck.trace_fingerprint(port_trace(tr)) == fp
    tcfg = port_cfg(cfg)
    assert t_ck.warm_key(tcfg, fp, steps) == j_warm_key(cfg, fp, steps)
    from primesim_tpu.sim.checkpoint import warm_cfg_key

    assert t_ck.warm_cfg_key(tcfg, fp) == warm_cfg_key(cfg, fp)


def test_warm_key_sensitivity():
    base = t_ck.warm_key(port_cfg(_chaos_cfg()), j_fp(_trace()), PREFIX)
    same = {n for n in KEYS if t_ck.warm_key(
        port_cfg(KEYS[n](_chaos_cfg())[0]), j_fp(_trace(KEYS[n](_chaos_cfg())[1])),
        KEYS[n](_chaos_cfg())[2]) == base}
    # the seed is unreachable with rates 0; events at or after the prefix
    # are not pinned
    assert same == {"base", "seed_rates0", "late_event", "no_events"}


def _forked(root, rec=None, n=4):
    fleet = _seed_fleet(n)
    st = t_prefix.execute_prefix_plan(fleet, _plan(fleet), warm_cache=True,
                                      cache_root=root, obs=rec)
    return fleet, st


def test_warm_cache_hit_skips_prefix_simulation(tmp_path):
    root = str(tmp_path / "warm")
    rec1 = Recorder("basic")
    fleet1, st1 = _forked(root, rec1)
    assert (st1["cache_hits"], st1["cache_misses"]) == (0, 1)
    assert rec1.store.summary()["labels"]["prefix"]["chunks"] == PREFIX // CHUNK

    rec2 = Recorder("basic")
    fleet2, st2 = _forked(root, rec2)
    assert (st2["cache_hits"], st2["cache_misses"]) == (1, 0)
    assert st2["prefix_wall_s"] == 0.0
    assert rec2.store.summary() is None  # no prefix chunk ran

    fleet1.run()
    fleet2.run()
    assert_fleets_equal(jax_fleet("4"), fleet1)
    assert_fleets_equal(jax_fleet("4"), fleet2)
    found = t_ck.find_warm_states(root, fleet1.elem_cfgs[0],
                                  t_ck.trace_fingerprint(fleet1.traces[0]))
    assert found == [(PREFIX, fleet1.prefix_cache_keys[0])]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warm_entries_cross_between_packages(tmp_path, writer):
    """An entry either package stores serves the other: a hit, no prefix
    simulated, and the forked fleet equal to the JAX one."""
    root = str(tmp_path / "warm")
    if writer == "jax":
        jf = JFleet(_chaos_cfg(), [_trace()] * 4, _seed_ovs(4), chunk_steps=CHUNK)
        groups = j_prefix.plan_prefix(jf.elem_cfgs, jf.traces, chunk_steps=CHUNK)
        st = j_prefix.execute_prefix_plan(jf, groups, warm_cache=True, cache_root=root)
        assert st["cache_misses"] == 1
        fleet, st = _forked(root)
        assert (st["cache_hits"], st["cache_misses"], st["prefix_wall_s"]) == (1, 0, 0.0)
        fleet.run()
        assert_fleets_equal(jax_fleet("4"), fleet)
        assert fleet.prefix_cache_keys == jf.prefix_cache_keys
    else:
        fleet, st = _forked(root)
        assert st["cache_misses"] == 1
        jf = JFleet(_chaos_cfg(), [_trace()] * 4, _seed_ovs(4), chunk_steps=CHUNK)
        groups = j_prefix.plan_prefix(jf.elem_cfgs, jf.traces, chunk_steps=CHUNK)
        st = j_prefix.execute_prefix_plan(jf, groups, warm_cache=True, cache_root=root)
        assert (st["cache_hits"], st["cache_misses"], st["prefix_wall_s"]) == (1, 0, 0.0)
        jf.run()
        fleet.run()
        assert_fleets_equal(jf, fleet)


def test_corrupt_cache_entry_falls_back_to_recompute(tmp_path):
    root = str(tmp_path / "warm")
    _, st1 = _forked(root)
    assert st1["cache_misses"] == 1
    npzs = [p for p in os.listdir(root) if p.endswith(".npz")]
    assert npzs
    for p in npzs:
        full = os.path.join(root, p)
        blob = open(full, "rb").read()
        with open(full, "wb") as f:
            f.write(blob[: len(blob) // 2])
    fleet2, st2 = _forked(root)
    assert (st2["cache_hits"], st2["cache_misses"]) == (0, 1)
    fleet2.run()
    assert_fleets_equal(jax_fleet("4"), fleet2)
    _, st3 = _forked(root)  # the bad entry was overwritten
    assert st3["cache_hits"] == 1


def test_load_warm_state_rejects_mismatched_key(tmp_path):
    root = str(tmp_path / "warm")
    _forked(root)
    fp = j_fp(_trace())
    cfg = port_cfg(_chaos_cfg())
    key = t_ck.warm_key(cfg, fp, PREFIX)
    other = t_apply(cfg, {"dram_lat": 200})
    with pytest.raises(ValueError, match="key does not match"):
        t_ck.load_warm_state(root, key, other, fp, PREFIX)
    with pytest.raises(ValueError, match="holds 32 steps"):
        t_ck.load_warm_state(root, key, cfg, fp, PREFIX + CHUNK)
    with pytest.raises(FileNotFoundError):
        t_ck.load_warm_state(root, "0" * 64, cfg, fp, PREFIX)
    snap = t_ck.load_warm_state(root, key, cfg, fp, PREFIX)
    assert int(snap["steps_run"]) == PREFIX and snap["state"].l1.device.type == "cpu"


def test_warm_store_under_disk_pressure_still_forks(tmp_path, monkeypatch):
    monkeypatch.setattr(t_dp.shutil, "disk_usage",
                        lambda p: shutil._ntuple_diskusage(1 << 40, 1 << 40, 0))
    root = str(tmp_path / "warm")
    fleet, st = _forked(root)
    assert (st["cache_hits"], st["cache_misses"], st["forked_elements"]) == (0, 1, 4)
    assert not [p for p in os.listdir(root) if p.endswith((".npz", ".json"))]
    fleet.run()
    assert_fleets_equal(jax_fleet("4"), fleet)


# ---- provenance and the supervisor ------------------------------------------


def test_solo_prefix_provenance_crosses_between_packages(tmp_path):
    cfg = _chaos_cfg()
    eng = Engine(port_cfg(cfg), port_trace(_trace()), chunk_steps=CHUNK, device="cpu")
    eng.run_steps(PREFIX)
    eng.prefix_steps, eng.prefix_cache_key = PREFIX, "ab" * 32
    p = str(tmp_path / "solo.npz")
    eng.save_checkpoint(p)
    je = JEngine(cfg, _trace(), chunk_steps=CHUNK)
    je.load_checkpoint(p)
    assert (je.prefix_steps, je.prefix_cache_key) == (PREFIX, "ab" * 32)
    je.save_checkpoint(p)
    back = Engine(port_cfg(cfg), port_trace(_trace()), chunk_steps=CHUNK, device="cpu")
    assert (back.prefix_steps, back.prefix_cache_key) == (0, None)
    back.load_checkpoint(p)
    assert (back.prefix_steps, back.prefix_cache_key) == (PREFIX, "ab" * 32)
    back.run()
    je.run()
    assert_engines_equal(je, back)


def _kill_at(chunk):
    def on_chunk(sup):
        if sup.committed == chunk:
            os.kill(os.getpid(), signal.SIGTERM)

    return on_chunk


def test_supervisor_resume_of_forked_run_bit_exact(tmp_path):
    def forked():
        fleet = _seed_fleet(4)
        t_prefix.execute_prefix_plan(fleet, _plan(fleet))
        return fleet

    ref = forked()
    RunSupervisor(ref).run()

    eng = forked()
    sup = RunSupervisor(eng, snapshot_dir=str(tmp_path), checkpoint_every_chunks=1,
                        on_chunk=_kill_at(2))
    with pytest.raises(Preempted):
        sup.run()
    assert not eng.done()

    # a fresh, unforked fleet: the snapshot alone carries everything
    eng2 = _seed_fleet(4)
    sup2 = RunSupervisor(eng2, snapshot_dir=str(tmp_path))
    assert sup2.resume() is not None
    assert any("resume-prefix" in ln for ln in sup2.log_lines())
    assert list(eng2.prefix_steps) == [PREFIX] * 4
    assert eng2.prefix_cache_keys == eng.prefix_cache_keys
    sup2.run()
    assert_fleets_equal(ref, eng2)
    np.testing.assert_array_equal(eng2.cycles, jax_fleet("4").cycles)

    # the JAX supervisor resumes the port's forked snapshot too
    jf = JFleet(_chaos_cfg(), [_trace()] * 4, _seed_ovs(4), chunk_steps=CHUNK)
    jsup = JSupervisor(jf, snapshot_dir=str(tmp_path))
    jsup.resume()
    assert any("resume-prefix" in ln for ln in jsup.log_lines())
    assert list(jf.prefix_steps) == [PREFIX] * 4


# ---- the CLI ----------------------------------------------------------------


def _write_cfg(tmp_path):
    p = str(tmp_path / "m.json")
    with open(p, "w") as f:
        f.write(MachineConfig(n_cores=8, n_banks=8).to_json())
    return p


def _write_schedule(tmp_path):
    p = str(tmp_path / "sched.json")
    with open(p, "w") as f:
        json.dump({"events": [{"step": EV_STEP, "kind": "link_degrade",
                               "link": 0, "extra": 3}]}, f)
    return p


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _elem_lines(lines):
    out = []
    for d in lines:
        if d["metric"] == "simulated_MIPS":
            det = dict(d["detail"])
            det.pop("wall_s")
            out.append(det)
    return out


def test_cli_sweep_fork_and_warm_cache_equal_primetpu(tmp_path, capsys, monkeypatch):
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    argv = ["sweep", _write_cfg(tmp_path), "--synth",
            "fft_like:n_phases=2,points_per_core=12",
            "--fault-schedule", _write_schedule(tmp_path),
            "--vary", "fault_seed=0", "--vary", "fault_seed=1",
            "--vary", "fault_seed=2", "--chunk-steps", "16",
            "--fork-prefix", "auto", "--warm-cache", "on"]
    monkeypatch.setenv("PRIMETPU_CACHE_DIR", str(tmp_path / "jcache"))
    assert jax_main(argv) == 0
    jl = _lines(capsys)
    jpf = [d for d in jl if d["metric"] == "prefix_fork"][0]
    monkeypatch.setenv("PRIMETPU_CACHE_DIR", str(tmp_path / "tcache"))
    pf = []
    for _ in range(2):
        assert main(argv + ["--device", "cpu"]) == 0
        tl = _lines(capsys)
        pf.append([d for d in tl if d["metric"] == "prefix_fork"][0])
        assert _elem_lines(tl) == _elem_lines(jl)
    for p in pf:
        assert set(p) == set(jpf) and set(p["detail"]) == set(jpf["detail"])
        assert p["value"] == jpf["value"] == 3
    cold = dict(pf[0]["detail"])
    cold.pop("prefix_wall_s")
    jcold = dict(jpf["detail"])
    jcold.pop("prefix_wall_s")
    assert cold == jcold
    assert (jcold["cache_hits"], jcold["cache_misses"]) == (0, 1)
    assert (pf[1]["detail"]["cache_hits"], pf[1]["detail"]["cache_misses"]) == (1, 0)
    assert pf[1]["detail"]["prefix_wall_s"] == 0.0


def test_cli_bad_fork_prefix_is_refused_as_primetpu_refuses_it(tmp_path):
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    argv = ["sweep", _write_cfg(tmp_path), "--synth", "fft_like:n_phases=2",
            "--fork-prefix", "soon"]
    with pytest.raises(SystemExit) as je:
        jax_main(argv)
    with pytest.raises(SystemExit) as te:
        main(argv + ["--device", "cpu"])
    assert str(te.value) == str(je.value) and "--fork-prefix must be" in str(te.value)
