"""The port's windowed streaming ingest (`ingest/stream.py`, the window
loop `sim/engine.py::stream_loop`, stream snapshots, the supervisor's
stream kind, `run --stream-window/--mmap`) against the JAX package, on
the CPU, mirroring tests/test_stream.py.

The machines are tests/test_stream.py's (a memory workload, a folded
local-run trace, seeded lock and barrier traces, cores of very uneven
lengths) and a small router + DRAM-queue + O3 machine. Each streamed run
equals the JAX package's preloaded `Engine` (run once per machine for the
module) in cycles, every counter, every state field but the epoch- and
window-relative ones (the clocks, `quantum_end`, `barrier_time`, the
link and controller clocks, `ptr`, and `step`, which the preloaded run
rounds up to whole chunks) and the cursors. On two machines, one with the
router, the port makes the JAX `StreamEngine`'s cuts: the same steps and
cursors after every window, and every state field, the cycle base and the
host counters equal at every cut. Stream snapshots resume across the two
packages both ways; a supervised stream preempted, resumed, and rolled
back after a window that failed after doing its work equals an
uninterrupted one. A core spinning at a barrier at its window's edge
forces one-step chunks, each with one host transfer. The CLI prints
`primetpu run`'s summary key for key and refuses what it refuses.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import functools
import json
import os
import signal

import numpy as np
import pytest
import torch

from primesim_tpu.cli import main as jax_main
from primesim_tpu.config.machine import CoreConfig, MachineConfig, NocConfig, small_test_config
from primesim_tpu.ingest.stream import StreamEngine as JStream
from primesim_tpu.sim import checkpoint as j_ck
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import (
    EV_BARRIER,
    EV_INS,
    EV_LD,
    Trace,
    fold_ins,
    from_event_lists,
)
from primesim_tpu_torch import convert
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.ingest.stream import StreamEngine
from primesim_tpu_torch.sim import checkpoint as t_ck
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim import supervisor as t_sup
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.sim.fleet import FleetEngine
from primesim_tpu_torch.stats.counters import COUNTER_NAMES

from test_torch_cli import _assert_same_summary, _summary
from test_torch_engine import jax_arrays, port_cfg, port_trace

# fields the preloaded and the streamed runs may differ in: the clocks
# are epoch-relative (the two rebase on other cadences; absolute cycles
# are compared through `cycles`), `ptr` is window-relative and `step` is
# rounded up to whole chunks by the preloaded run
RELATIVE = ("ptr", "cycles", "quantum_end", "barrier_time", "step", "link_free", "dram_free")

ROUTER = small_test_config(
    8, n_banks=8, quantum=500, dram_queue=True, dram_service=40, local_run_len=4,
    core=CoreConfig(o3_overlap_256=64),
    noc=NocConfig(mesh_x=4, mesh_y=2, contention=True, contention_model="router"),
)
MACHINES = {
    "memory": (small_test_config(8, n_banks=4, quantum=300),
               synth.false_sharing(8, n_mem_ops=40, seed=81)),
    "folded": (small_test_config(8, n_banks=4, local_run_len=4),
               fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=82))),
    "lock": (small_test_config(8, n_banks=4, quantum=200),
             synth.lock_contention(8, n_critical=8, seed=83)),
    "barrier": (small_test_config(8, n_banks=4, quantum=200),
                synth.barrier_phases(8, n_phases=3, seed=84)),
    "uneven": (small_test_config(4, n_banks=4), from_event_lists([
        [(EV_LD, 4, i * 64) for i in range(50)],
        [(EV_INS, 10, 0), (EV_LD, 4, 7 * 64)],
        [],
        [(EV_LD, 4, i * 64) for i in range(23)],
    ])),
    "router": (ROUTER, fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=24))),
}
RUNS = [("memory", 4), ("memory", 16), ("memory", 64), ("folded", 8), ("lock", 8),
        ("barrier", 8), ("uneven", 5), ("router", 16)]


@functools.lru_cache(maxsize=None)
def preloaded(name):
    """The JAX package's preloaded run of a machine, once for the module."""
    cfg, tr = MACHINES[name]
    eng = JEngine(cfg, tr, chunk_steps=32)
    eng.run()
    return eng


def _port(name, window, trace=None):
    cfg, tr = MACHINES[name]
    return StreamEngine(port_cfg(cfg), port_trace(trace or tr), window_events=window,
                        device="cpu")


def assert_matches_preloaded(name, eng):
    ref = preloaded(name)
    np.testing.assert_array_equal(eng.cycles, ref.cycles, err_msg="cycles")
    for k in COUNTER_NAMES:
        np.testing.assert_array_equal(eng.counters[k], ref.counters[k], err_msg=k)
    t, j = convert.state_to_numpy(eng.state), jax_arrays(ref.state)
    assert set(t) == set(j)
    for f in set(j) - set(RELATIVE):
        for k in (j[f] if isinstance(j[f], dict) else [None]):
            a, b = (t[f][k], j[f][k]) if k else (t[f], j[f])
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {k}")
    np.testing.assert_array_equal(eng.cursor, np.asarray(MACHINES[name][1].lengths) - 1)
    assert eng.done()


def _windows(eng):
    """Run window by window: [(steps, cursor, host copy of the state,
    cycle base, summed counters)] at every cut."""
    cuts, budget = [], eng._default_budget()
    while True:
        k, finished = eng._advance_window(budget)
        budget -= k
        st = eng.state
        host = (convert.state_to_numpy(st) if isinstance(st.cycles, torch.Tensor)
                else jax_arrays(st))
        # copies: the port's step writes the L1 and the directory in place
        host = {f: ({k: np.copy(v) for k, v in a.items()} if isinstance(a, dict)
                    else np.copy(a)) for f, a in host.items()}
        cuts.append((k, eng.cursor.copy(), host, int(eng.cycle_base),
                     {c: np.asarray(v).copy() for c, v in eng.host_counters.items()}))
        if finished:
            return cuts


@pytest.mark.parametrize("name,window", RUNS)
def test_stream_equals_the_preloaded_jax_engine(name, window):
    eng = _port(name, window)
    eng.run()
    assert_matches_preloaded(name, eng)
    assert len(eng.window_chunks) >= 2 and min(eng.window_chunks) >= 1


@pytest.mark.parametrize("name", ["barrier", "router"])
def test_window_cuts_equal_the_jax_stream_engine(name):
    """The same (steps, cursor) after every window, and at every cut the
    same state, field for field, the same cycle base and host counters."""
    cfg, tr = MACHINES[name]
    window = 8 if name == "barrier" else 16
    jcuts = _windows(JStream(cfg, tr, window_events=window))
    tcuts = _windows(_port(name, window))
    assert [(k, c.tolist()) for k, c, *_ in tcuts] == [(k, c.tolist()) for k, c, *_ in jcuts]
    assert len(tcuts) > 2
    for i, (t, j) in enumerate(zip(tcuts, jcuts)):
        for f in j[2]:
            for k in (j[2][f] if isinstance(j[2][f], dict) else [None]):
                a, b = (t[2][f][k], j[2][f][k]) if k else (t[2][f], j[2][f])
                np.testing.assert_array_equal(a, b, err_msg=f"cut {i} {f} {k}")
        assert t[3] == j[3], f"cut {i} cycle base"
        for c in COUNTER_NAMES:
            np.testing.assert_array_equal(t[4][c], j[4][c], err_msg=f"cut {i} {c}")


@pytest.mark.parametrize("line_addressed", [True, False])
def test_mmap_round_trip(tmp_path, line_addressed):
    """A memory-mapped trace streams to the in-memory run's results; a
    byte-addressed one is line-normalised window by window."""
    cfg, tr = MACHINES["memory"]
    if line_addressed:
        tr = Trace(tr.line_events(cfg.line_bits), tr.lengths,
                   line_addressed=True, line_bits=cfg.line_bits)
    p = str(tmp_path / "big.ptpu")
    tr.save(p)
    from primesim_tpu_torch.trace.format import Trace as TTrace

    mm = TTrace.load(p, mmap=True)
    assert isinstance(mm.events, np.memmap) and mm.line_addressed == line_addressed
    eng = StreamEngine(port_cfg(cfg), mm, window_events=16, device="cpu")
    eng.run()
    assert_matches_preloaded("memory", eng)


def test_undersized_window_faults_and_a_missing_card_are_refused(monkeypatch):
    cfg = small_test_config(4, local_run_len=8)
    tr = synth.stream(4, n_mem_ops=4)
    with pytest.raises(ValueError) as je:
        JStream(cfg, tr, window_events=4)
    with pytest.raises(ValueError) as te:
        StreamEngine(port_cfg(cfg), port_trace(tr), window_events=4, device="cpu")
    assert str(te.value) == str(je.value) and "window_events" in str(te.value)
    faulted = dataclasses.replace(cfg, faults_enabled=True, max_fault_events=1,
                                  fault_events=((5, 1, 0, 0),))
    with pytest.raises(ValueError, match="does not compose with --stream-window"):
        StreamEngine(port_cfg(faulted), port_trace(tr), window_events=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(port_cfg(cfg), port_trace(tr), window_events=16)


# ---- stream snapshots --------------------------------------------------------


@pytest.mark.parametrize("name", ["lock", "router"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_snapshots_cross_between_the_packages(tmp_path, name, direction):
    cfg, tr = MACHINES[name]
    window = 8 if name == "lock" else 16
    half = int((np.asarray(tr.lengths) - 1).sum()) // 2
    path = str(tmp_path / "s.npz")
    if direction == "jax_to_port":
        first = JStream(cfg, tr, window_events=window)
        assert not first.run_events(half)
        first.save_checkpoint(path)
        second = _port(name, window)
    else:
        first = _port(name, window)
        assert not first.run_events(half)
        first.save_checkpoint(path)
        second = JStream(cfg, tr, window_events=window)
    cut = first.cursor.copy()
    second.load_checkpoint(path)
    np.testing.assert_array_equal(second.cursor, cut)
    second.run()
    whole = _port(name, window)
    whole.run()
    assert second.steps_run == whole.steps_run
    np.testing.assert_array_equal(second.cycles, whole.cycles)
    for k in COUNTER_NAMES:
        np.testing.assert_array_equal(second.counters[k], whole.counters[k], err_msg=k)
    if direction == "jax_to_port":
        assert_matches_preloaded(name, second)


def test_stream_snapshot_keys_and_refusals(tmp_path):
    """The port's stream snapshot has the JAX package's keys and dtypes;
    the stream loader refuses solo and fleet snapshots and a mismatched
    window, config or trace with the JAX package's messages, and the solo
    loader refuses a stream snapshot."""
    cfg, tr = MACHINES["lock"]
    t, j = _port("lock", 8), JStream(cfg, tr, window_events=8)
    t.run_events(100)
    j.run_events(100)
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t.save_checkpoint(tp)
    j.save_checkpoint(jp)
    tz, jz = t_ck.load_verified_npz(tp), j_ck.load_verified_npz(jp)
    assert set(tz) == set(jz)
    for k in jz:
        assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape, k
        if k not in ("crc_json",):
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)

    solo = Engine(port_cfg(cfg), port_trace(tr), chunk_steps=16, device="cpu")
    solo.run_steps(16)
    solo.save_checkpoint(sp := str(tmp_path / "solo.npz"))
    fleet = FleetEngine(port_cfg(cfg), [port_trace(tr)] * 2, [{}, {"llc_lat": 20}],
                        chunk_steps=16, device="cpu")
    fleet.run_steps(16)
    fleet.save_checkpoint(fp := str(tmp_path / "fleet.npz"))

    def refusal(load, path, *targets):
        msgs = []
        for target in targets:
            with pytest.raises(ValueError) as e:
                load(path, target)
            msgs.append(str(e.value))
        return msgs

    for p in (sp, fp):
        got = refusal(lambda p_, e: e.load_checkpoint(p_), p, _port("lock", 8),
                      JStream(cfg, tr, window_events=8))
        assert got[0] == got[1] == f"{p}: not a compatible streaming checkpoint"
    got = refusal(lambda p_, e: e.load_checkpoint(p_), tp, _port("lock", 16),
                  JStream(cfg, tr, window_events=16))
    assert got[0] == got[1] and "windows must match" in got[0]
    other = synth.lock_contention(8, n_critical=8, seed=99)
    got = refusal(lambda p_, e: e.load_checkpoint(p_), tp, _port("lock", 8, other),
                  JStream(cfg, other, window_events=8))
    assert got[0] == got[1] == f"{tp}: checkpoint trace does not match engine"
    cfg2 = dataclasses.replace(cfg, quantum=300)
    got = refusal(lambda p_, e: e.load_checkpoint(p_), tp,
                  StreamEngine(port_cfg(cfg2), port_trace(tr), window_events=8, device="cpu"),
                  JStream(cfg2, tr, window_events=8))
    assert got[0] == got[1] == f"{tp}: checkpoint config does not match engine"
    got = refusal(lambda p_, e: e.load_checkpoint(p_), tp,
                  Engine(port_cfg(cfg), port_trace(tr), chunk_steps=16, device="cpu"),
                  JEngine(cfg, tr, chunk_steps=16))
    assert got[0] == got[1] and "resume it with a StreamEngine" in got[0]


# ---- the supervisor's stream kind --------------------------------------------


def _kill_at(chunk):
    def on_chunk(sup):
        if sup.committed == chunk:
            os.kill(os.getpid(), signal.SIGTERM)

    return on_chunk


@functools.lru_cache(maxsize=None)
def streamed(name, window):
    eng = _port(name, window)
    eng.run()
    return eng


def _assert_same_stream(eng, ref):
    assert eng.steps_run == ref.steps_run
    np.testing.assert_array_equal(eng.cursor, ref.cursor)
    np.testing.assert_array_equal(eng.cycles, ref.cycles)
    for k in COUNTER_NAMES:
        np.testing.assert_array_equal(eng.counters[k], ref.counters[k], err_msg=k)
    t, r = convert.state_to_numpy(eng.state), convert.state_to_numpy(ref.state)
    for f in r:
        for k in (r[f] if isinstance(r[f], dict) else [None]):
            a, b = (t[f][k], r[f][k]) if k else (t[f], r[f])
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {k}")


def test_supervised_stream_preempted_and_resumed(tmp_path):
    eng = _port("barrier", 8)
    sup = t_sup.RunSupervisor(eng, snapshot_dir=str(tmp_path), checkpoint_every_chunks=2,
                              guard="fail", on_chunk=_kill_at(5))
    assert sup.kind == "stream"
    with pytest.raises(t_sup.Preempted) as ei:
        sup.run()
    assert sup.committed == 5 and not eng.done()
    eng2 = _port("barrier", 8)
    sup2 = t_sup.RunSupervisor(eng2, snapshot_dir=str(tmp_path), guard="fail")
    assert sup2.resume() == ei.value.checkpoint
    sup2.run()
    _assert_same_stream(eng2, streamed("barrier", 8))
    assert_matches_preloaded("barrier", eng2)
    # the final snapshot is a stream snapshot the JAX package resumes
    cfg, tr = MACHINES["barrier"]
    j = JStream(cfg, tr, window_events=8)
    j.load_checkpoint(t_sup.SnapshotStore(str(tmp_path)).snapshots()[0])
    np.testing.assert_array_equal(j.cursor, eng2.cursor)
    assert j.done()


def test_supervised_stream_rolls_back_a_window_that_failed_after_its_work():
    """The failed window has run: its steps updated the L1 and the
    directory in place and advanced the cursors. The retry starts from
    the supervisor's device copy and the host's cursors and counters, so
    the run equals an uninterrupted one; a rollback that kept the old
    state object would replay the window on its own writes."""
    eng = _port("router", 16)
    real, calls = eng._advance_window, []

    def flaky(budget):
        calls.append(1)
        out = real(budget)
        if len(calls) == 3:
            raise RuntimeError("UNAVAILABLE: died after the window")
        return out

    eng._advance_window = flaky
    sup = t_sup.RunSupervisor(eng, backoff_s=0.001, guard="fail")
    sup.run()
    assert sup.retries == 1 and len(calls) == sup.committed + 1
    assert sup.rollback_copies == len(calls)
    _assert_same_stream(eng, streamed("router", 16))
    assert_matches_preloaded("router", eng)


def test_supervised_stream_budget_exhaustion_keeps_the_jax_text():
    with pytest.raises(RuntimeError, match="exhausted with the stream unfinished"):
        t_sup.RunSupervisor(_port("memory", 16)).run(max_steps=20)


# ---- chunks at a window's edge ------------------------------------------------


def _spinning_trace():
    """Core 0 reaches a barrier after four events and spins there while
    core 1 works through 30 cache misses to it. With local runs of 2 (3
    events a step) and 5-event windows, every window starts with core 0
    on the barrier holding 5 events: more than one step's, fewer than
    two's, so every chunk of those windows is one step."""
    return from_event_lists([
        [(EV_INS, 1, 0)] * 4 + [(EV_BARRIER, 2, 0)] + [(EV_INS, 1, 0)] * 20,
        [(EV_LD, 0, (i * 4096) % (1 << 20)) for i in range(30)] + [(EV_BARRIER, 2, 0)],
    ])


def test_barrier_spin_at_a_window_edge_makes_one_transfer_a_chunk(monkeypatch):
    cfg = small_test_config(2, n_banks=2, local_run_len=2)
    tr = _spinning_trace()
    eng = StreamEngine(port_cfg(cfg), port_trace(tr), window_events=5, device="cpu")
    calls = {"chunks": 0, "transfers": 0}
    real_chunk, real_cpu = t_engine.window_chunk, torch.Tensor.cpu

    def chunk(*a, **kw):
        calls["chunks"] += 1
        return real_chunk(*a, **kw)

    def cpu(self, *a, **kw):
        calls["transfers"] += 1
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(t_engine, "window_chunk", chunk)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for sync in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, sync, lambda *a, _s=sync: pytest.fail(_s))
    steps, budget = [], eng._default_budget()
    while True:
        k, finished = eng._advance_window(budget)
        budget -= k
        steps.append(k)
        if finished:
            break
    monkeypatch.undo()
    assert calls["chunks"] == sum(eng.window_chunks) == calls["transfers"]
    one_step = [i for i, (k, n) in enumerate(zip(steps, eng.window_chunks)) if k == n > 1]
    assert len(one_step) >= 5, (steps, eng.window_chunks)
    ref = JEngine(cfg, tr, chunk_steps=16)
    ref.run()
    np.testing.assert_array_equal(eng.cycles, ref.cycles)
    for k in COUNTER_NAMES:
        np.testing.assert_array_equal(eng.counters[k], ref.counters[k], err_msg=k)
    assert eng.counters["barrier_waits"].sum() > 0


# ---- the CLI ---------------------------------------------------------------------


@pytest.fixture()
def files(tmp_path):
    cfg = str(tmp_path / "m.json")
    with open(cfg, "w") as f:
        f.write(MachineConfig(n_cores=8, n_banks=8).to_json())
    tr = str(tmp_path / "t.ptpu")
    synth.false_sharing(8, n_mem_ops=30, seed=86).save(tr)
    return cfg, tr


@pytest.mark.parametrize("mode", ["plain", "obs", "supervised"])
def test_cli_stream_window_summary_matches_primetpu(files, tmp_path, capsys, mode):
    cfg, tr = files
    args = ["run", cfg, "--trace", tr, "--mmap", "--stream-window", "16"]
    if mode == "obs":
        args += ["--obs", "basic"]
    if mode == "supervised":
        args += ["--checkpoint-every", "2", "--guard", "fail"]
    jargs = args + (["--checkpoint-dir", str(tmp_path / "j")] if mode == "supervised" else [])
    targs = args + (["--checkpoint-dir", str(tmp_path / "t")] if mode == "supervised" else [])
    assert jax_main(jargs) == 0
    j = _summary(capsys.readouterr().out)
    assert main(targs + ["--device", "cpu"]) == 0
    t = _summary(capsys.readouterr().out)
    if mode == "supervised":
        for k in ("supervised", "committed_chunks", "checkpoints_written", "retries",
                  "guard", "guard_warnings", "stalled_elements", "degrade_rungs"):
            assert t["detail"][k] == j["detail"][k], k
        assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
        for k in ("supervised", "committed_chunks", "checkpoints_written", "resumed_from",
                  "retries", "guard", "guard_warnings", "stalled_elements", "degrade_rungs"):
            j["detail"].pop(k)
            t["detail"].pop(k)
    _assert_same_summary(j, t)
    if mode == "obs":
        assert t["detail"]["timeline"]["chunks"] >= 2  # one sample a window
    assert main(["run", cfg, "--trace", tr, "--device", "cpu"]) == 0
    pre = _summary(capsys.readouterr().out)  # the preloaded run
    for k in ("instructions", "max_core_cycles", "noc_msgs"):
        assert t["detail"][k] == pre["detail"][k], k
    assert t["detail"]["steps"] <= pre["detail"]["steps"]


@pytest.mark.parametrize("extra", [
    ["--mmap", "--trace", "@t.ptpu"],
    ["--stream-window", "16", "--fault-schedule", "@s.json"],
    ["--stream-window", "16", "--xprof", "@prof"],
    ["--stream-window", "16", "--debug-invariants"],
])
def test_cli_stream_refusals_match_primetpu(files, tmp_path, extra):
    cfg, tr = files
    with open(tmp_path / "s.json", "w") as f:
        json.dump({"events": [{"step": 5, "kind": "core_failstop", "core": 1}]}, f)
    args = ["run", cfg, "--trace", tr,
            *[str(tmp_path / a[1:]) if a[0] == "@" else a for a in extra]]
    with pytest.raises(SystemExit) as je:
        jax_main(args)
    with pytest.raises(SystemExit) as te:
        main(args + ["--device", "cpu"])
    assert str(te.value) == str(je.value) and "--" in str(te.value)
