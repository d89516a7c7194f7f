"""Overlapped chunk dispatch (`Engine.overlap`, `FleetEngine.overlap`,
`--overlap on`) against the JAX package, on the CPU.

The port's step is not functional: the commit and the fault scrub write
the L1, the directory and the counters in place. So the speculated next
chunk runs on a copy of the committed state, and what a caller reads
between chunks (a snapshot, a chain head, the guard) must still be the
committed chunk's. The cases of tests/test_exec_cache.py that concern
overlap, mapped:

- test_overlap_bit_exact_solo_and_fleet: `test_solo_overlap_equals_jax`
  (four machines, among them scheduled and random kills whose scrub
  steps the speculated chunk must take from the next chunk, and the
  router machine with barriers) and `test_fleet_overlap_equals_jax`
  (`run`, which freezes finished elements, and `run_steps`);
- test_overlap_discard_on_state_surgery: `test_state_surgery_drops_the_
  prefetch` (checkpoint loads, splices, overlays, forks and event
  uploads, each then run to the end equal to the same surgery without
  overlap) and `test_a_stale_prefetch_is_not_adopted` (another source
  state, another chunk size, another run mode);
- test_overlap_preempt_resume_bit_exact:
  `test_preempt_resume_rollback_every_checkpoint_is_jax`: preempted,
  resumed and rolled back under overlap with a snapshot after every
  chunk, every snapshot equal member for member (the state's leaves,
  the counters, the chain head) to the JAX engine's checkpoint at the
  same step. It fails if the speculation writes the committed state;
- test_prefix_fork_composes_with_cache (the fork half):
  `test_forked_fleet_under_overlap_equals_the_unforked`;
- the CLI: `run`, `sweep` and `worker` take `--overlap`, print what they
  print without it (but for walls), and a streamed run warns and runs
  without it, as `primetpu run` does.

JAX reference runs are made once per machine at module scope.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from primesim_tpu.attest import SoloAttest as JSolo
from primesim_tpu.config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    CoreConfig,
    NocConfig,
    small_test_config,
)
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.fleet import FleetEngine as JFleet
from primesim_tpu.trace import synth
from primesim_tpu_torch.attest import SoloAttest
from primesim_tpu_torch.sim import checkpoint as t_ck
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim import supervisor as t_sup
from primesim_tpu_torch.sim.engine import Engine, Prefetch
from primesim_tpu_torch.sim.fleet import FleetEngine
from primesim_tpu_torch.sim.prefix import execute_prefix_plan, plan_prefix

from test_torch_engine import assert_engines_equal, port_cfg, port_trace
from test_torch_fleet import assert_fleets_equal

CHUNK = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNG1 = os.path.join(REPO, "configs", "rung1_64core_fft.json")


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PRIMETPU_CACHE_DIR", str(tmp_path / "cache"))


def _cfg(**kw):
    return small_test_config(8, n_banks=4, quantum=200, **kw)


def _armed(**kw):
    kw.setdefault("max_fault_events", max(1, len(kw.get("fault_events", ()))))
    return dataclasses.replace(_cfg(), faults_enabled=True, **kw)


def _router(**kw):
    noc = NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1,
                    contention=True, contention_model="router", contention_lat=2)
    return small_test_config(8, n_banks=4, quantum=400, noc=noc, dram_queue=True,
                             dram_service=8, core=CoreConfig(o3_overlap_256=64), **kw)


def _trace(n_mem_ops=96, seed=3):
    return synth.uniform_random(8, n_mem_ops=n_mem_ops, shared_frac=0.4, seed=seed)


MACHINES = {
    "plain": lambda: (_cfg(), _trace()),
    # a kill at step 40, inside the third chunk: the chunk speculated when
    # the second commits must scrub at its offset 8
    "failstop": lambda: (_armed(fault_events=((40, FAULT_CORE_FAILSTOP, 2, 0),),
                                fault_dead_policy="drop"), _trace(128)),
    "due_failstop": lambda: (_armed(fault_flip_l1=0.004, fault_due_rate=0.5,
                                    fault_due_failstop=True, fault_seed=4,
                                    fault_dead_policy="drop"), _trace(128)),
    "router_sync": lambda: (_router(faults_enabled=True, max_fault_events=1,
                                    fault_events=((20, FAULT_CORE_FAILSTOP, 3, 0),)),
                            synth.barrier_phases(8, n_phases=3, work_per_phase=8, seed=5)),
}
# the in-place test's machine: a degraded link, a kill and random L1 flips
FAULTED = lambda: (_armed(max_fault_events=2, fault_seed=5, fault_flip_l1=0.01,  # noqa: E731
                          fault_events=((40, FAULT_LINK_DEGRADE, 0, 3),
                                        (50, FAULT_CORE_FAILSTOP, 3, 0))), _trace())


@functools.lru_cache(maxsize=None)
def jax_run(name):
    cfg, tr = MACHINES[name]()
    je = JEngine(cfg, tr, chunk_steps=CHUNK)
    je.run_chunked()
    return je


def _port(cfg, tr, overlap=True, chunk=CHUNK):
    eng = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=chunk, device="cpu")
    eng.overlap = overlap
    return eng


@pytest.mark.parametrize("name", list(MACHINES))
def test_solo_overlap_equals_jax(name):
    cfg, tr = MACHINES[name]()
    eng = _port(cfg, tr)
    adopted = []
    real = t_engine.adopt

    def spy(p):
        adopted.append(p.chunk_steps)
        return real(p)

    t_engine.adopt = spy
    try:
        eng.run()
    finally:
        t_engine.adopt = real
    assert_engines_equal(jax_run(name), eng, name)
    # every chunk after the first was the speculated one
    assert len(adopted) == eng.steps_run // CHUNK - 1 > 0
    if name == "failstop":
        assert eng.counters["core_failstops"].sum() == 1


FLEET_OVS = [{}, {"llc_lat": 25}, {"quantum": 500}]


def _fleet_traces():
    return [_trace(96, 11), synth.false_sharing(8, n_mem_ops=40, seed=47), _trace(64, 12)]


@functools.lru_cache(maxsize=None)
def jax_fleet(mode):
    jf = JFleet(_cfg(), _fleet_traces(), FLEET_OVS, chunk_steps=CHUNK)
    jf.run() if mode == "run" else jf.run_steps(10_000)
    return jf


def _port_fleet(overlap=True, traces=None, ovs=None):
    fl = FleetEngine(port_cfg(_cfg()), [port_trace(t) for t in traces or _fleet_traces()],
                     ovs or FLEET_OVS, chunk_steps=CHUNK, device="cpu")
    fl.overlap = overlap
    return fl


@pytest.mark.parametrize("mode", ["run", "run_steps"])
def test_fleet_overlap_equals_jax(mode):
    fl = _port_fleet()
    fl.run() if mode == "run" else fl.run_steps(10_000)
    assert_fleets_equal(jax_fleet(mode), fl)


def _surgery_fleet(overlap):
    """A fleet part-way through its run (a speculation pending when
    `overlap`)."""
    fl = _port_fleet(overlap)
    fl.run_steps(2 * CHUNK)
    assert (fl._pending is not None) == overlap
    return fl


SURGERY = ("solo_load_checkpoint", "replace_element", "restore_element",
           "fork_element", "upload_events", "fleet_load_checkpoint")


@pytest.mark.parametrize("what", SURGERY)
def test_state_surgery_drops_the_prefetch(what, tmp_path):
    """Each surgery drops the speculated chunk, and the run it continues
    equals the same surgery without overlap, bit for bit."""
    if what == "solo_load_checkpoint":
        cfg, tr = MACHINES["failstop"]()
        src = _port(cfg, tr, overlap=False)
        src.run_steps(3 * CHUNK)
        src.save_checkpoint(str(tmp_path / "s.npz"))
        outs = []
        for overlap in (True, False):
            eng = _port(cfg, tr, overlap)
            eng.run_steps(CHUNK)
            assert (eng._pending is not None) == overlap
            eng.load_checkpoint(str(tmp_path / "s.npz"))
            assert eng._pending is None
            eng.run()
            outs.append(eng)
        assert_engines_equal(jax_run("failstop"), outs[0], what)
        assert_engines_equal(jax_run("failstop"), outs[1], what)
        return
    other = port_trace(_trace(80, 21))
    donor = _port_fleet(False)
    donor.run_steps(3 * CHUNK)
    snap = {"state": donor.element_state(1), "cycle_base": donor.cycle_base[1],
            "steps_run": donor.steps_run[1],
            "host_counters": {k: v[1].copy() for k, v in donor.counters.items()}}
    if what == "fleet_load_checkpoint":
        donor.save_checkpoint(str(tmp_path / "f.npz"))
    fleets = []
    for overlap in (True, False):
        fl = _surgery_fleet(overlap)
        if what == "replace_element":
            fl.replace_element(0, other, {"llc_lat": 30})
        elif what == "restore_element":
            fl.restore_element(1, snap)
        elif what == "fork_element":
            fl.fork_element(1, snap)
        elif what == "upload_events":
            fl.replace_element(2, other, upload=False)
            fl._pending = Prefetch(fl.state, None, CHUNK, False, None) if overlap else None
            fl.upload_events()
        else:
            fl.load_checkpoint(str(tmp_path / "f.npz"))
        assert fl._pending is None
        fl.run_steps(10_000)
        fleets.append(fl)
    assert_fleets_equal(fleets[1], fleets[0])


def test_a_stale_prefetch_is_not_adopted():
    """A speculation is adopted only from the very state object it was
    made from, at the chunk size and run mode it was made for."""
    cfg, tr = MACHINES["plain"]()
    eng = _port(cfg, tr)
    eng.run_steps(2 * CHUNK)
    # another source: the identity check rejects garbage results
    eng._pending = Prefetch(eng.state._replace(), ("bogus",), CHUNK, None, None)
    eng.run_steps(CHUNK)
    # another chunk size (the supervisor's OOM halving): rejected too
    eng.chunk_steps = CHUNK // 2
    eng.run()
    ref = JEngine(cfg, tr, chunk_steps=CHUNK)
    ref.run_steps(3 * CHUNK)
    ref.chunk_steps = CHUNK // 2
    ref.run_chunked()
    assert_engines_equal(ref, eng, "stale")
    # a fleet speculation made by run_steps is not adopted by run (which
    # freezes finished elements); the port without overlap, held to the
    # JAX fleet above, is the reference
    fl, ref = _port_fleet(), _port_fleet(False)
    for f in (fl, ref):
        f.run_steps(CHUNK)
    assert fl._pending is not None and fl._pending.key is False
    for f in (fl, ref):
        f.run()
    assert_fleets_equal(ref, fl)


@functools.lru_cache(maxsize=None)
def jax_checkpoints(tmp_root):
    """The JAX engine with a chain, a checkpoint after every chunk:
    {steps: npz members}, and the finished engine."""
    cfg, tr = FAULTED()
    je = JEngine(cfg, tr, chunk_steps=CHUNK)
    je.attest = JSolo(CHUNK)
    out = {}
    while not je.done():
        je.run_steps(CHUNK)
        path = os.path.join(tmp_root, f"jax-{je.steps_run}.npz")
        je.save_checkpoint(path)
        out[je.steps_run] = t_ck.load_verified_npz(path)
    return out, je


def test_preempt_resume_rollback_every_checkpoint_is_jax(tmp_path_factory):
    """Preempted after chunk 2, resumed in a fresh engine whose second
    chunk fails after its work and is rolled back, under overlap, with a
    snapshot after every committed chunk: each snapshot, member for
    member, is the JAX engine's checkpoint at the same step (every state
    leaf, the host counters and clocks, the chain head), and the end is
    the JAX run's. A speculation that wrote the committed state would
    put the next chunk's L1, directory or counters into these snapshots."""
    jdir = tmp_path_factory.mktemp("jax_ck")
    want, je = jax_checkpoints(str(jdir))
    snaps = tmp_path_factory.mktemp("snaps")
    cfg, tr = FAULTED()

    def engine():
        eng = _port(cfg, tr)
        eng.attest = SoloAttest(CHUNK)
        return eng

    def supervisor(eng, **kw):
        return t_sup.RunSupervisor(eng, snapshot_dir=str(snaps), keep_snapshots=1000,
                                   checkpoint_every_chunks=1, guard="fail",
                                   backoff_s=0.001, **kw)

    def kill_at(n):
        def on_chunk(sup):
            if sup.committed == n:
                os.kill(os.getpid(), signal.SIGTERM)
        return on_chunk

    eng = engine()
    with pytest.raises(t_sup.Preempted):
        supervisor(eng, on_chunk=kill_at(2)).run()
    eng = engine()
    sup = supervisor(eng)
    assert sup.resume() is not None and eng.steps_run == 2 * CHUNK
    real, calls = eng.run_steps, [0]

    def fails_after_its_work(n):
        calls[0] += 1
        done = real(n)
        if calls[0] == 2:
            assert eng._pending is not None  # a speculation is in flight
            raise RuntimeError("UNAVAILABLE: died after the work")
        return done

    eng.run_steps = fails_after_its_work
    sup.run()
    assert sup.retries == 1
    seen = set()
    for name in sorted(os.listdir(snaps)):
        z = t_ck.load_verified_npz(str(snaps / name))
        steps = int(z["steps_run"])
        seen.add(steps)
        w = want[steps]
        assert sorted(z) == sorted(w), name
        for k in w:
            np.testing.assert_array_equal(z[k], w[k], err_msg=f"{name} (step {steps}): {k}")
            assert z[k].dtype == w[k].dtype, (name, k)
    assert seen == set(want)  # a snapshot at every chunk boundary
    assert_engines_equal(je, eng, "resumed")
    assert eng.attest.payload() == je.attest.payload()
    assert eng.counters["core_failstops"].sum() == 1


def test_forked_fleet_under_overlap_equals_the_unforked():
    """Prefix forking composes with overlap: the fork's overlay drops any
    speculation, and the forked fleet equals the unforked one run without
    overlap (which tests/test_torch_prefix.py holds to the JAX fleet)."""
    cfg = port_cfg(_armed(max_fault_events=1, fault_events=((40, FAULT_LINK_DEGRADE, 0, 3),)))
    tr = port_trace(_trace())
    ovs = [{"fault_seed": 100 + i} for i in range(3)]
    ref = FleetEngine(cfg, [tr] * 3, ovs, chunk_steps=CHUNK, device="cpu")
    ref.run()
    fl = FleetEngine(cfg, [tr] * 3, ovs, chunk_steps=CHUNK, device="cpu")
    fl.overlap = True
    groups = plan_prefix(fl.elem_cfgs, fl.traces, chunk_steps=CHUNK)
    assert groups and groups[0].prefix_steps > 0
    st = execute_prefix_plan(fl, groups)
    assert st["forked_elements"] == 3 and fl._pending is None
    fl.run()
    np.testing.assert_array_equal(fl.cycles, ref.cycles)
    for k, v in ref.counters.items():
        np.testing.assert_array_equal(fl.counters[k], v, err_msg=k)


# ---- the CLI ---------------------------------------------------------------

SPEC = "fft_like:n_phases=1,points_per_core=16"


def _cli(args, env=None):
    r = subprocess.run([sys.executable, "-m", "primesim_tpu_torch", *args, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, **(env or {})})
    assert r.returncode == 0, r.stderr
    return r


def _lines(out):
    got = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    for ln in got:
        ln.pop("value", None)
        ln["detail"].pop("wall_s", None)
    return got


def test_cli_overlap_prints_what_it_prints_without(tmp_path):
    """`run` (supervised, with a chain) and `sweep` with `--overlap on`
    print the same lines as without the flag, but for walls; a streamed
    run warns and runs without overlap."""
    run = ["run", RUNG1, "--synth", SPEC, "--fold", "--chunk-steps", "16",
           "--attest", "chain"]
    sup = ["--checkpoint-dir", str(tmp_path / "ck{}"), "--checkpoint-every", "1"]
    outs = [_lines(_cli(run + [a.format(i) for a in sup] + flag).stdout)
            for i, flag in enumerate(([], ["--overlap", "on"]))]
    assert outs[0] == outs[1]
    sweep = ["sweep", RUNG1, "--synth", SPEC, "--fold", "--chunk-steps", "16",
             "--vary", "llc_lat=20", "--vary", "link_lat=2"]
    assert _lines(_cli(sweep).stdout) == _lines(_cli(sweep + ["--overlap", "on"]).stdout)
    r = _cli(["run", RUNG1, "--synth", SPEC, "--stream-window", "32", "--overlap", "on"])
    assert "overlap: the stream engine's next window is produced by" in r.stderr
