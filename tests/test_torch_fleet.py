"""The port's fleet (`primesim_tpu_torch/sim/fleet.py`) against the JAX
`FleetEngine` and against the port's own solo `Engine`, on the CPU.

Each batched kernel wrapper (its plain version here) is held, element by
element, to the JAX package's Pallas kernel run as its tests run it
(interpret mode) with that element's own latency knobs. Each fleet is
held bit for bit to the JAX fleet (every state field, cycles, all
counters, steps run) and each element to a solo run of its effective
config (`apply_overrides`), under both run modes: `run` freezes a
finished element whole, step counter included; `run_steps` steps every
element, so a finished element's step counter runs ahead while the rest
of its state stays equal. Fleet snapshots cross between the packages in
both directions. Tolerance 0 everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import CoreConfig, NocConfig, small_test_config
from primesim_tpu.sim.fleet import FleetEngine as JFleet
from primesim_tpu.trace import synth
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.kernels import reductions, router_kernels, step_kernels
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.sim.fleet import KNOB_KEYS, FleetEngine, apply_overrides

from test_torch_engine import assert_states_equal, port_cfg, port_trace
from test_torch_kernels import (
    _cfgs,
    _check_probe,
    _commit_both,
    _commit_inputs,
    _probe_inputs,
    _stage,
    _words,
    j_probe,
    j_reduce,
)
from test_torch_router import _cascade_both, _cascade_inputs

FS_, LF_ = 1, 2  # fault kinds: core fail-stop, link fail

B = 3
LATS = [(1, 1), (3, 2), (2, 5)]  # (link, router) latency of each element


def _stack(per_elem, bool_at=()):
    """[B, ...] torch tensors from each element's numpy arrays; `cid`
    (position 4 of the probe, 7 of the commit) stays shared."""
    out = []
    for k, arrs in enumerate(zip(*per_elem)):
        a = np.stack(arrs)
        out.append(torch.from_numpy(a != 0 if k in bool_at else a))
    return out


# ------------------------------------------------------------ batched kernels


@pytest.mark.parametrize("rl", [0, 2])
def test_batched_probe_classify_equals_pallas_per_element(rl):
    jcfg, tcfg = _cfgs(64)
    elems = [_probe_inputs(jcfg, 900 + 10 * b + rl, rl) for b in range(B)]
    t_in = _stack(elems, bool_at=(6, 7))
    t_in[4] = t_in[4][0]  # cid [C], shared
    t_out = step_kernels.probe_classify(tcfg, *t_in)
    assert t_out[0].shape[0] == B
    for b, arrs in enumerate(elems):
        l1, dirm, slot, line, cid, step = arrs[:6]
        vrows, mrows = _stage(jcfg, l1, dirm, slot, line)
        j_out = j_probe(jcfg, l1, vrows, mrows, line, cid, step, *arrs[6:])
        _check_probe(jcfg, j_out, [x[b] for x in t_out], mrows)


def test_batched_commit_step_equals_pallas_per_element():
    jcfg, tcfg = _cfgs(64)
    elems = [_commit_inputs(jcfg, 700 + b, 2) for b in range(B)]
    t_in = _stack(elems, bool_at=(11, 12))
    t_in[7] = t_in[7][0]  # cid [C], shared
    assert step_kernels.commit_step(tcfg, *t_in) is None
    for b, arrs in enumerate(elems):
        (j_l1, j_dirm, j_cnt), _ = _commit_both(jcfg, tcfg, arrs)
        for name, j, t in (("l1", j_l1, t_in[0]), ("dirm", j_dirm, t_in[1]),
                           ("counters", j_cnt, t_in[9])):
            np.testing.assert_array_equal(t[b].numpy(), np.asarray(j), err_msg=f"{b} {name}")


def test_batched_sharer_reductions_equal_pallas_per_element():
    """Each element's own link and router latency, rows with bit 31."""
    jcfg, tcfg = _cfgs(64)
    C, NW = jcfg.n_cores, jcfg.n_sharer_words
    elems = []
    for b in range(B):
        rng = np.random.default_rng(500 + b)
        elems.append([
            _words(rng, (C, NW)), _words(rng, (C, NW)),
            rng.integers(0, jcfg.n_tiles, C).astype(np.int32),
            rng.integers(-1, C, C).astype(np.int32),
            rng.random(C) < 0.5, rng.random(C) < 0.5,
            np.arange(C, dtype=np.int32),
            np.asarray(LATS[b][0], np.int32), np.asarray(LATS[b][1], np.int32),
        ])
    t_in = _stack(elems)
    t_in[6] = t_in[6][0]  # cid
    t_out = reductions.sharer_reductions(tcfg, *t_in)
    outs = []
    for b, arrs in enumerate(elems):
        j_out = j_reduce(jcfg, *arrs)
        for n, j, t in zip(("inv_lat", "inv_cnt", "inv_hops", "back_cnt", "back_hops"),
                           j_out, t_out):
            np.testing.assert_array_equal(t[b].numpy(), np.asarray(j), err_msg=f"{b} {n}")
        outs.append(t_out[0][b])
    assert not torch.equal(outs[0], outs[1])  # the latencies reach the result


@pytest.mark.parametrize("has_sync", [False, True])
def test_batched_router_cascade_equals_pallas_per_element(has_sync):
    """Each element's departures land in its own row of link_free_out."""
    elems = [_cascade_inputs(16, (4, 4), has_sync, 40 + b) for b in range(B)]
    t = _stack(elems, bool_at=(3,))
    out = t[0].clone()
    got = router_kernels.router_cascade(
        *t[:9], t[9] if has_sync else None,
        torch.tensor([L for L, _ in LATS], dtype=torch.int32),
        torch.tensor([R for _, R in LATS], dtype=torch.int32),
        out, has_sync=has_sync,
    )
    for b, arrs in enumerate(elems):
        want, _ = _cascade_both(arrs, *LATS[b], has_sync)
        for n, w, g in zip(("t_rep_end", "t_arr_end", "link_free_out"), want,
                           (got[0][b], got[1][b] if has_sync else None, out[b])):
            if w is None:
                assert g is None
                continue
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{b} {n}")


# ------------------------------------------------------------ whole fleets


def _router_cfg(**kw):
    noc = NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1,
                    contention=True, contention_model="router", contention_lat=2)
    return small_test_config(8, n_banks=4, quantum=400, noc=noc, dram_queue=True,
                             dram_service=8, core=CoreConfig(o3_overlap_256=64), **kw)


def _tile_dram_cfg():
    cfg = small_test_config(8, n_banks=4, dram_queue=True, dram_service=20)
    return dataclasses.replace(
        cfg, noc=dataclasses.replace(cfg.noc, contention=True, contention_model="tile")
    )


def _torus_moesi_cfg():
    noc = NocConfig(mesh_x=4, mesh_y=4, link_lat=1, router_lat=2, topology="torus")
    return small_test_config(16, n_banks=4, quantum=400, noc=noc, coherence="moesi",
                             prefetcher="stride")


def _faults_cfg():
    """Scheduled kills and a link failure, sparse L1 and LLC flips with
    DUE fail-stops, and a link failure at step 150, after the short
    element has finished (a frozen element's events must not fire)."""
    return dataclasses.replace(
        small_test_config(8, n_banks=4, quantum=200), faults_enabled=True,
        max_fault_events=4,
        fault_events=((5, FS_, 3, 0), (0, LF_, 0, 0), (40, FS_, 6, 0), (150, LF_, 5, 0)),
        fault_flip_l1=0.004, fault_flip_llc=0.01, fault_due_rate=0.5,
        fault_due_failstop=True, fault_dead_policy="drop",
    )


def _ur(n, m, seed, **kw):
    return synth.uniform_random(n, n_mem_ops=m, shared_frac=0.4, seed=seed, **kw)


# name: (JAX config, traces, overrides, chunk_steps)
FLEETS = {
    "mixed": (
        small_test_config(8, n_banks=4, quantum=300),
        [synth.false_sharing(8, n_mem_ops=40, seed=11),
         synth.uniform_random(8, n_mem_ops=60, seed=12),
         synth.lock_contention(8, n_critical=6, seed=13),
         synth.barrier_phases(8, n_phases=3, seed=14)],
        [{}, {"llc_lat": 25, "dram_lat": 140, "l1_lat": 4}, {"quantum": 150, "cpi": 2},
         {"link_lat": 3, "router_lat": 2, "cpi": [1, 2, 1, 2, 3, 1, 1, 2]}],
        32,
    ),
    "contention_dram": (
        _tile_dram_cfg(),
        [synth.false_sharing(8, n_mem_ops=40, seed=21),
         synth.uniform_random(8, n_mem_ops=50, seed=22),
         synth.fft_like(8, n_phases=2, points_per_core=12, seed=23)],
        [{}, {"contention_lat": 7, "dram_service": 35},
         {"dram_service": 0, "dram_lat": 90, "contention_lat": 2}],
        32,
    ),
    "router": (
        _router_cfg(),
        [synth.false_sharing(8, n_mem_ops=40, seed=31), _ur(8, 50, 32),
         synth.barrier_phases(8, n_phases=3, work_per_phase=8, seed=33)],
        [{}, {"link_lat": 4, "quantum": 250}, {"router_lat": 5, "dram_service": 3}],
        16,
    ),
    "uneven": (
        small_test_config(4, n_banks=4),
        [synth.stream(4, n_mem_ops=4, seed=61), synth.uniform_random(4, n_mem_ops=120, seed=62),
         synth.stream(4, n_mem_ops=40, seed=63)],
        [{}, {}, {"llc_lat": 3}],
        8,
    ),
    "torus_moesi": (
        _torus_moesi_cfg(),
        [synth.fft_like(16, n_phases=2, points_per_core=16, ins_per_mem=4, seed=42),
         synth.readers_writer(16, n_rounds=4, seed=5)],
        [{"prefetch_degree": 1}, {"prefetch_lat": 9, "link_lat": 2}],
        32,
    ),
    "coarse": (
        small_test_config(16, n_banks=4, quantum=400, sharer_group=4),
        [_ur(16, 48, 71), synth.fft_like(16, n_phases=2, points_per_core=12, seed=72)],
        [{"router_lat": 3}, {"link_lat": 2, "llc_lat": 12}],
        32,
    ),
    "faults": (
        _faults_cfg(),
        [_ur(8, 96, 81), _ur(8, 96, 81), _ur(8, 12, 82)],
        [{"fault_seed": 1}, {"fault_seed": 2, "llc_lat": 20}, {"fault_seed": 3}],
        32,
    ),
}
_RUNS: dict = {}


def fleets(name, mode="run"):
    """(JAX fleet, port fleet) of FLEETS[name], each driven by `mode`
    ("run", or "run_steps" far enough for every element to finish)."""
    key = (name, mode)
    if key not in _RUNS:
        jcfg, trs, ovs, chunk = FLEETS[name]
        jf = JFleet(jcfg, trs, ovs, chunk_steps=chunk)
        tf = FleetEngine(port_cfg(jcfg), [port_trace(t) for t in trs], ovs,
                         chunk_steps=chunk, device="cpu")
        for f in (jf, tf):
            f.run() if mode == "run" else f.run_steps(100_000)
        _RUNS[key] = jf, tf
    return _RUNS[key]


def assert_fleets_equal(jf, tf):
    np.testing.assert_array_equal(tf.steps_run, jf.steps_run)
    np.testing.assert_array_equal(tf.cycles, jf.cycles)
    jc, tc = jf.counters, tf.counters
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=f"counter {k}")
    assert_states_equal(jf.state, tf.state, "fleet")


def assert_element_matches_solo(tf, i, skip=()):
    """Element i against a solo port Engine on its effective config."""
    cfg = apply_overrides(tf.cfg, tf.element_overrides[i])
    solo = Engine(cfg, tf.traces[i], chunk_steps=tf.chunk_steps, device="cpu")
    solo.run()
    np.testing.assert_array_equal(tf.cycles[i], solo.cycles, err_msg=f"{i} cycles")
    fc = tf.element_counters(i)
    for k, v in solo.counters.items():
        np.testing.assert_array_equal(fc[k], v, err_msg=f"{i} counter {k}")
    es = tf.element_state(i)
    for f in es._fields:
        if f in skip:
            continue
        a, b = getattr(es, f), getattr(solo.state, f)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), f"{i} state field {f}"
    assert tf.steps_run[i] == solo.steps_run
    return solo


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_run_equals_the_jax_fleet(name):
    jf, tf = fleets(name)
    assert tf.done() and list(tf.done_mask()) == [True] * tf.n_elements
    assert_fleets_equal(jf, tf)


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_elements_equal_solo_runs(name):
    _, tf = fleets(name)
    for i in range(tf.n_elements):
        assert_element_matches_solo(tf, i)


def test_shared_static_choices():
    """Any element with sync events turns the sync phase on for all; the
    elements really differ where their knobs differ."""
    _, tf = fleets("mixed")
    assert tf.has_sync
    assert len({int(tf.cycles[i].max()) for i in range(tf.n_elements)}) == tf.n_elements
    _, tr = fleets("router")
    assert tr.state.link_free.shape == (3, tr.cfg.n_tiles * 4)
    assert not torch.equal(tr.state.link_free[0], tr.state.link_free[1])


def test_run_freezes_a_finished_element_step_counter_included():
    jf, tf = fleets("uneven")
    assert len(set(tf.steps_run.tolist())) == 3  # finished chunks apart
    np.testing.assert_array_equal(tf.state.step.numpy(), np.asarray(jf.state.step))
    np.testing.assert_array_equal(tf.state.step.numpy(), tf.steps_run)


@pytest.mark.parametrize("name", ["uneven", "faults"])
def test_run_steps_steps_every_element(name):
    """Under run_steps a finished element's step counter runs ahead of a
    solo run's, as in the JAX package; the rest of its state is the solo
    run's."""
    jf, tf = fleets(name, "run_steps")
    assert_fleets_equal(jf, tf)
    short = int(np.argmin(tf.steps_run))
    solo = assert_element_matches_solo(tf, short, skip=("step",) if name == "uneven" else
                                       ("step", "faults"))
    assert int(tf.state.step[short]) > int(solo.state.step) == solo.steps_run


def test_faults_vary_by_seed_and_a_frozen_element_fires_nothing():
    jf, tf = fleets("faults")
    c = tf.counters
    assert all(c["core_failstops"][i].sum() > 0 for i in range(3))
    # one trace, two seeds: the flips differ
    assert not np.array_equal(c["ecc_corrected"][0], c["ecc_corrected"][1])
    # the step-150 link failure: frozen under run, fired under run_steps
    short = 2
    assert tf.steps_run[short] < 150
    assert int(tf.state.faults.link_dead[short, 5]) == 0
    _, ts = fleets("faults", "run_steps")
    assert int(ts.state.faults.link_dead[short, 5]) == 1


def _errors(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", ["empty", "unpaired", "unknown", "pallas", "quantum", "cores"])
def test_fleet_rejections_match_the_jax_messages(case):
    jcfg = small_test_config(4, n_banks=4)
    tr = synth.stream(4, n_mem_ops=10, seed=51)
    args = {
        "empty": (jcfg, [], None),
        "unpaired": (jcfg, [tr], [{}, {}]),
        "unknown": (jcfg, [tr], [{"llc_latency": 3}]),
        "pallas": (small_test_config(4, n_banks=4, pallas_reduce=True), [tr], None),
        "quantum": (jcfg, [tr], [{"quantum": 2**30}]),
        "cores": (jcfg, [synth.stream(8, n_mem_ops=10, seed=51)], None),
    }[case]
    j = _errors(lambda: JFleet(*args))
    t = _errors(lambda: FleetEngine(port_cfg(args[0]), [port_trace(x) for x in args[1]],
                                    args[2], device="cpu"))
    assert t == j


def test_knob_keys_and_overrides_are_the_jax_package_s():
    from primesim_tpu.sim.fleet import KNOB_KEYS as J_KEYS
    from primesim_tpu.sim.fleet import apply_overrides as j_apply

    assert KNOB_KEYS == J_KEYS
    jcfg = small_test_config(8, n_banks=4)
    ov = {"quantum": 700, "cpi": [1, 2] * 4, "l1_lat": 3, "llc_lat": 9, "link_lat": 2,
          "router_lat": 4, "dram_lat": 77, "dram_service": 5, "contention_lat": 6,
          "prefetch_degree": 3, "prefetch_lat": 11, "fault_seed": 99}
    assert apply_overrides(port_cfg(jcfg), ov).to_json() == j_apply(jcfg, ov).to_json()


def test_fleet_without_a_card_or_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, trs, ovs, _ = FLEETS["uneven"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetEngine(port_cfg(jcfg), [port_trace(t) for t in trs], ovs)


# ------------------------------------------------------------ checkpoints


def _ckpt_fleet(pkg, name):
    jcfg, trs, ovs, chunk = FLEETS[name]
    if pkg == "jax":
        return JFleet(jcfg, trs, ovs, chunk_steps=chunk)
    return FleetEngine(port_cfg(jcfg), [port_trace(t) for t in trs], ovs,
                       chunk_steps=chunk, device="cpu")


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("name", ["router", "faults"])
def test_fleet_checkpoint_crosses_between_the_packages(src, dst, name, tmp_path):
    """A snapshot taken mid-run (run_steps) by one package resumes in the
    other exactly as in its own package, to the uninterrupted run's
    cycles and counters (an element that finished before the snapshot
    keeps the step counter run_steps gave it)."""
    jf, _ = fleets(name)
    a = _ckpt_fleet(src, name)
    a.run_steps(64)
    path = str(tmp_path / "fleet.npz")
    a.save_checkpoint(path)
    resumed = {}
    for pkg in (src, dst):
        resumed[pkg] = _ckpt_fleet(pkg, name)
        resumed[pkg].load_checkpoint(path)
        np.testing.assert_array_equal(np.asarray(resumed[pkg].steps_run), a.steps_run)
        resumed[pkg].run()
    assert_fleets_equal(resumed["jax"], resumed["port"])
    np.testing.assert_array_equal(resumed[dst].cycles, jf.cycles)
    for k, v in jf.counters.items():
        np.testing.assert_array_equal(resumed[dst].counters[k], v, err_msg=k)


def test_solo_loader_refuses_a_fleet_file(tmp_path):
    _, tf = fleets("uneven")
    path = str(tmp_path / "fleet.npz")
    tf.save_checkpoint(path)
    jcfg, trs, _, chunk = FLEETS["uneven"]
    eng = Engine(port_cfg(jcfg), port_trace(trs[0]), chunk_steps=chunk, device="cpu")
    with pytest.raises(ValueError, match="fleet checkpoint — resume it with a FleetEngine"):
        eng.load_checkpoint(path)
    other = _ckpt_fleet("port", "mixed")
    with pytest.raises(ValueError, match="element configs do not match"):
        other.load_checkpoint(path)


def test_batched_state_helpers_round_trip():
    from primesim_tpu_torch.sim.state import (
        batch_state,
        element_state,
        init_state,
        solo_state,
        stack_states,
    )

    cfgs = [apply_overrides(TCfg(n_cores=8, n_banks=4), {"quantum": q}) for q in (100, 300)]
    st = stack_states((init_state(c, "cpu") for c in cfgs), 2)
    assert st.knobs.quantum.tolist() == [100, 300] and st.knobs.cpi.shape == (2, 8)
    assert int(element_state(st, 1).quantum_end) == 300
    one = batch_state(element_state(st, 0))
    assert one.dirm.shape == (1, *st.dirm.shape[1:])
    assert solo_state(one).dirm.data_ptr() == st.dirm.data_ptr()
