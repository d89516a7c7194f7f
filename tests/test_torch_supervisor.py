"""The port's supervised runs (`primesim_tpu_torch/sim/supervisor.py`,
`util/backoff.py`, `util/diskpressure.py`) against the JAX package, on
the CPU.

The machines are tests/test_supervisor.py's: `small_test_config(8,
n_banks=4, quantum=200)` on `fft_like(8, 2 phases, 12 points, seed 41)`
in chunks of 16, a two-element fleet (a second trace, an llc_lat
override), and a faulted machine whose link degrades at step 40 and whose
core 3 fail-stops at step 50 (the scrub rewrites the directory in place)
under L1 flips. Each JAX reference runs once per module. Preemption lands
at an exact chunk boundary (SIGTERM from the `on_chunk` callback); the
resumed run, a retried run and a run rolled back after a chunk that
failed after doing its work all equal the JAX engine in cycles, every
counter and every state field. Snapshots cross between the two packages'
supervisors. Disk pressure is made by patching `shutil.disk_usage`.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import functools
import json
import os
import random
import shutil
import signal

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    MachineConfig,
    small_test_config,
)
from primesim_tpu.sim import supervisor as j_sup
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.fleet import FleetEngine as JFleet
from primesim_tpu.trace import synth
from primesim_tpu.util import backoff as j_backoff
from primesim_tpu.util import diskpressure as j_dp
from primesim_tpu_torch.sim import checkpoint as t_ck
from primesim_tpu_torch.sim import supervisor as t_sup
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.sim.fleet import FleetEngine
from primesim_tpu_torch.sim.state import leaves
from primesim_tpu_torch.util import backoff as t_backoff
from primesim_tpu_torch.util import diskpressure as t_dp

from test_torch_engine import assert_engines_equal, port_cfg, port_trace
from test_torch_fleet import assert_fleets_equal

CHUNK = 16


@pytest.fixture(autouse=True)
def _clean_disk_governance(tmp_path, monkeypatch):
    """Each test starts with the port's disk governance unconfigured, its
    registries empty and the warm cache under tmp_path."""
    monkeypatch.setenv("PRIMETPU_CACHE_DIR", str(tmp_path / "cache"))
    t_dp.configure(None)
    t_dp._EVICTORS.clear()
    t_dp._COMPACTORS.clear()
    yield
    t_dp.configure(None)
    t_dp._EVICTORS.clear()
    t_dp._COMPACTORS.clear()


def _cfg():
    return small_test_config(8, n_banks=4, quantum=200)


def _trace(seed=41):
    return synth.fft_like(8, n_phases=2, points_per_core=12, seed=seed)


def _faulted_cfg():
    return dataclasses.replace(
        _cfg(), faults_enabled=True, max_fault_events=2, fault_seed=5,
        fault_events=((40, FAULT_LINK_DEGRADE, 0, 3), (50, FAULT_CORE_FAILSTOP, 3, 0)),
        fault_flip_l1=0.01,
    )


FLEET_OVS = [{}, {"llc_lat": 25}]


def _fleet_traces():
    return [_trace(45), synth.false_sharing(8, n_mem_ops=40, seed=47)]


def _port(kind):
    """A fresh port engine of one of the three machines, on the CPU."""
    if kind == "fleet":
        return FleetEngine(port_cfg(_cfg()), [port_trace(t) for t in _fleet_traces()],
                           FLEET_OVS, chunk_steps=CHUNK, device="cpu")
    cfg = _faulted_cfg() if kind == "faulted" else _cfg()
    return Engine(port_cfg(cfg), port_trace(_trace()), chunk_steps=CHUNK, device="cpu")


def _jax(kind):
    if kind == "fleet":
        return JFleet(_cfg(), _fleet_traces(), FLEET_OVS, chunk_steps=CHUNK)
    cfg = _faulted_cfg() if kind == "faulted" else _cfg()
    return JEngine(cfg, _trace(), chunk_steps=CHUNK)


@functools.lru_cache(maxsize=None)
def jax_ref(kind):
    """The JAX engine run to the end under its own supervisor (the fleet's
    chunked cadence ticks finished elements' step counters, so its full
    state is compared at the same cadence)."""
    eng = _jax(kind)
    j_sup.RunSupervisor(eng, handle_signals=False).run()
    return eng


def _equal(kind, eng):
    if kind == "fleet":
        assert_fleets_equal(jax_ref(kind), eng)
    else:
        assert_engines_equal(jax_ref(kind), eng, kind)


def _kill_at(chunk):
    def on_chunk(sup):
        if sup.committed == chunk:
            os.kill(os.getpid(), signal.SIGTERM)

    return on_chunk


# ---- failure classification and backoff -----------------------------------

FAILURES = [
    RuntimeError("RESOURCE_EXHAUSTED: oom"),
    RuntimeError("Out of memory allocating"),
    torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.10 GiB total "
        "capacity; 77.00 GiB already allocated)"),
    RuntimeError("UNAVAILABLE: socket"),
    RuntimeError("DEADLINE_EXCEEDED"),
    RuntimeError("INTERNAL: stream did not block host until done"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    RuntimeError("CUDA driver error: device not ready"),
    RuntimeError("NCCL error: unhandled system error, Socket closed"),
    RuntimeError("DEVICE_LOST: injected revocation of device id(s) [3]"),
    OSError("DiskPressureError: disk full"),
    t_dp.DiskPressureError("disk pressure: checkpoint write"),
    RuntimeError("something else"),
    ValueError("UNAVAILABLE"),
    ValueError("DeviceMeshError: 3 devices do not divide 8 banks"),
    AssertionError("RESOURCE_EXHAUSTED"),
    KeyboardInterrupt(),
]


@pytest.mark.parametrize("exc", FAILURES, ids=lambda e: f"{type(e).__name__}:{str(e)[:24]}")
def test_classify_failure_gives_the_jax_answer(exc):
    assert t_sup.classify_failure(exc) == j_sup.classify_failure(exc)


def test_classify_failure_reads_cuda_out_of_memory_as_oom():
    assert t_sup.classify_failure(FAILURES[2]) == "oom"
    assert t_sup.classify_failure(FAILURES[6]) is None  # sticky: never retried


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_decorrelated_jitter_draws_the_jax_schedule(seed):
    t = t_backoff.DecorrelatedJitter(0.25, 8.0, rng=random.Random(seed))
    j = j_backoff.DecorrelatedJitter(0.25, 8.0, rng=random.Random(seed))
    got = [t.next_delay() for _ in range(12)]
    assert got == [j.next_delay() for _ in range(12)]
    assert got[0] == 0.25 and max(got) <= 8.0
    t.reset()
    j.reset()
    assert t.next_delay() == j.next_delay() == 0.25
    for h in (0.0, 1.5, 40.0):
        assert (t_backoff.jittered(h, rng=random.Random(seed))
                == j_backoff.jittered(h, rng=random.Random(seed)))
    with pytest.raises(ValueError, match="0 < base <= cap"):
        t_backoff.DecorrelatedJitter(2.0, 1.0)


def test_job_context_logs_the_jax_decisions():
    t, j = t_sup.JobContext(max_retries=2, backoff_s=0.1), j_sup.JobContext(2, 0.1)
    for e in (RuntimeError("UNAVAILABLE: a"), RuntimeError("ABORTED: b"),
              RuntimeError("UNAVAILABLE: c"), ValueError("bad")):
        assert t.next_retry(e) == j.next_retry(e)
    assert t.log == j.log and t.attempts == j.attempts == 2


# ---- snapshot rotation ------------------------------------------------------


def test_snapshot_store_rotation_and_names(tmp_path):
    ts = t_sup.SnapshotStore(str(tmp_path / "t"), keep=3)
    js = j_sup.SnapshotStore(str(tmp_path / "j"), keep=3)

    def save(path):
        t_ck.atomic_save_npz(path, x=np.zeros(1))

    tp = [os.path.basename(ts.save(save)) for _ in range(5)]
    jp = [os.path.basename(js.save(save)) for _ in range(5)]
    assert tp == jp == [f"ckpt-{i:08d}.npz" for i in range(1, 6)]
    assert [os.path.basename(p) for p in ts.snapshots()] == [
        "ckpt-00000005.npz", "ckpt-00000004.npz", "ckpt-00000003.npz"]
    assert os.path.basename(ts.save(save)) == "ckpt-00000006.npz"
    # the store is a priority-1 evictor that keeps the newest snapshot
    assert t_dp._EVICTORS[f"snapshots:{ts.dir}"][0] == 1
    t_dp._EVICTORS[f"snapshots:{ts.dir}"][1](0)
    assert [os.path.basename(p) for p in ts.snapshots()] == ["ckpt-00000006.npz"]


# ---- preempt + resume -------------------------------------------------------


@pytest.mark.parametrize("kind", ["solo", "fleet"])
@pytest.mark.parametrize("seed", [0, 1])
def test_preempt_resume_bit_exact(tmp_path, kind, seed):
    kill_chunk = 1 + int(np.random.default_rng(seed).integers(0, 3))
    eng = _port(kind)
    sup = t_sup.RunSupervisor(
        eng, snapshot_dir=str(tmp_path), checkpoint_every_chunks=1,
        guard="fail", on_chunk=_kill_at(kill_chunk),
    )
    with pytest.raises(t_sup.Preempted) as ei:
        sup.run()
    assert ei.value.checkpoint is not None and os.path.exists(ei.value.checkpoint)
    assert ei.value.signum == signal.SIGTERM and not eng.done()
    assert sup.committed == kill_chunk
    assert any("preempt: SIGTERM" in ln for ln in sup.log_lines())

    eng2 = _port(kind)
    sup2 = t_sup.RunSupervisor(eng2, snapshot_dir=str(tmp_path), guard="fail")
    assert sup2.resume() == ei.value.checkpoint
    sup2.run()
    _equal(kind, eng2)


def test_preempt_without_snapshot_dir():
    sup = t_sup.RunSupervisor(_port("solo"), on_chunk=_kill_at(1))
    with pytest.raises(t_sup.Preempted) as ei:
        sup.run()
    assert ei.value.checkpoint is None


def test_second_signal_raises_keyboard_interrupt():
    def double_kill(sup):
        if sup.committed == 1:
            os.kill(os.getpid(), signal.SIGTERM)
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(KeyboardInterrupt):
        t_sup.RunSupervisor(_port("solo"), on_chunk=double_kill).run()


@pytest.mark.parametrize("kind", ["solo", "fleet", "faulted"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshots_cross_between_the_supervisors(tmp_path, kind, direction):
    """A snapshot one package's supervisor writes at a preemption resumes
    under the other's, bit-exactly."""
    d = str(tmp_path)
    first, second, sup_a, sup_b = (
        (_port, _jax, t_sup, j_sup) if direction == "port_to_jax"
        else (_jax, _port, j_sup, t_sup))
    eng = first(kind)
    with pytest.raises(sup_a.Preempted):
        sup_a.RunSupervisor(eng, snapshot_dir=d, checkpoint_every_chunks=2,
                            on_chunk=_kill_at(3)).run()
    eng2 = second(kind)
    sup = sup_b.RunSupervisor(eng2, snapshot_dir=d)
    assert os.path.basename(sup.resume()) == "ckpt-00000002.npz"
    sup.run()
    if direction == "port_to_jax":
        ref = jax_ref(kind)
        np.testing.assert_array_equal(eng2.cycles, ref.cycles)
        for k, v in ref.counters.items():
            np.testing.assert_array_equal(eng2.counters[k], v, err_msg=k)
    else:
        _equal(kind, eng2)


# ---- corrupt-snapshot fallback ----------------------------------------------


def _snapshots(tmp_path, kill_chunk=3):
    eng = _port("solo")
    sup = t_sup.RunSupervisor(eng, snapshot_dir=str(tmp_path),
                              checkpoint_every_chunks=1, on_chunk=_kill_at(kill_chunk))
    with pytest.raises(t_sup.Preempted):
        sup.run()
    return t_sup.SnapshotStore(str(tmp_path)).snapshots()


def test_resume_falls_back_past_corrupt_newest(tmp_path):
    snaps = _snapshots(tmp_path)
    assert len(snaps) >= 2
    blob = open(snaps[0], "rb").read()
    with open(snaps[0], "wb") as f:
        f.write(blob[: len(blob) // 3])  # torn newest
    eng = _port("solo")
    sup = t_sup.RunSupervisor(eng, snapshot_dir=str(tmp_path))
    assert sup.resume() == snaps[1]
    assert any("resume-skip" in ln for ln in sup.log_lines())
    sup.run()
    _equal("solo", eng)


def test_resume_all_corrupt_raises(tmp_path):
    for p in _snapshots(tmp_path):
        with open(p, "wb") as f:
            f.write(b"not an npz")
    sup = t_sup.RunSupervisor(_port("solo"), snapshot_dir=str(tmp_path))
    with pytest.raises(t_ck.CheckpointCorrupt, match="all .* corrupt"):
        sup.resume()


def test_resume_empty_dir_starts_fresh(tmp_path):
    sup = t_sup.RunSupervisor(_port("solo"), snapshot_dir=str(tmp_path))
    assert sup.resume() is None
    assert any("starting fresh" in ln for ln in sup.log_lines())
    with pytest.raises(ValueError, match="requires a snapshot_dir"):
        t_sup.RunSupervisor(_port("solo")).resume()


def test_resume_wrong_run_is_hard_error(tmp_path):
    _snapshots(tmp_path)
    other = Engine(port_cfg(_cfg()), port_trace(_trace(99)), chunk_steps=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="trace does not match"):
        t_sup.RunSupervisor(other, snapshot_dir=str(tmp_path)).resume()


# ---- retry, degradation and the rollback ------------------------------------


def _flaky(eng, fail_calls, text, after_work=False):
    """Make eng.run_steps raise RuntimeError(text) on the given calls;
    with `after_work` it runs the real chunk first."""
    orig, calls = eng.run_steps, [0]

    def flaky(n):
        calls[0] += 1
        if calls[0] in fail_calls:
            if after_work:
                orig(n)
            raise RuntimeError(text)
        return orig(n)

    eng.run_steps = flaky
    return calls


def test_oom_halves_chunk_and_stays_bit_exact():
    eng = _port("solo")
    _flaky(eng, (1, 2), "CUDA out of memory. Tried to allocate 20.00 MiB")
    sup = t_sup.RunSupervisor(eng, backoff_s=0.01)
    sup.run()
    assert eng.chunk_steps == 4  # 16 -> 8 -> 4
    assert sup.retries == 2
    assert any("degrade: device OOM: chunk_steps 16 -> 8" in ln for ln in sup.log_lines())
    ref = jax_ref("solo")
    np.testing.assert_array_equal(eng.cycles, ref.cycles)
    for k, v in ref.counters.items():
        np.testing.assert_array_equal(eng.counters[k], v, err_msg=k)


def test_transient_retry_with_backoff_then_success():
    eng = _port("solo")
    _flaky(eng, (1, 2, 3), "UNAVAILABLE: connection to device lost")
    sup = t_sup.RunSupervisor(eng, backoff_s=0.001)
    sup.run()
    assert sup.retries == 3 and eng.chunk_steps == CHUNK
    _equal("solo", eng)


def test_device_loss_takes_the_transient_path():
    eng = _port("solo")
    _flaky(eng, (2,), "DEVICE_LOST: device lost", after_work=True)
    sup = t_sup.RunSupervisor(eng, backoff_s=0.001)
    sup.run()
    assert sup.retries == 1 and sup.summary()["degrade_rungs"] == []
    _equal("solo", eng)


def test_retry_exhaustion_gives_up_with_the_original_error():
    eng = _port("solo")

    def always_down(n):
        raise RuntimeError("UNAVAILABLE: device gone")

    eng.run_steps = always_down
    sup = t_sup.RunSupervisor(eng, max_retries=2, backoff_s=0.001)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        sup.run()
    assert sup.retries == 2
    assert [ln.split("] ")[1].split(":")[0] for ln in sup.log_lines()] == [
        "retry", "retry", "give-up"]
    assert eng.device.type == "cpu" and eng.steps_run == 0


def test_permanent_error_is_not_retried():
    eng = _port("solo")

    def broken(n):
        raise ValueError("deliberate config error")

    eng.run_steps = broken
    sup = t_sup.RunSupervisor(eng, backoff_s=0.001)
    with pytest.raises(ValueError, match="deliberate"):
        sup.run()
    assert sup.retries == 0


@pytest.mark.parametrize("kind,fail_call", [("solo", 2), ("fleet", 2), ("faulted", 4)])
def test_failed_dispatch_rolls_back_the_device_state(kind, fail_call):
    """A chunk that dies AFTER its work (the port's step has already
    updated the L1, the directory and the counters in place; in the
    faulted case the chunk holds core 3's kill and its scrub) is retried
    from a state equal to the one before it, bit for bit."""
    eng = _port(kind)
    calls = _flaky(eng, (fail_call,), "UNAVAILABLE: died after the work", after_work=True)
    sup = t_sup.RunSupervisor(eng, backoff_s=0.001, guard="fail")
    sup.run()
    assert sup.retries == 1 and calls[0] == sup.committed + 1
    assert sup.rollback_copies == calls[0]
    assert sup.rollback_bytes == sum(x.numel() * x.element_size() for x in leaves(eng.state))
    if kind == "faulted":
        assert eng.counters["core_failstops"].sum() == 1
    _equal(kind, eng)


# ---- invariant guard --------------------------------------------------------


def _corrupt_at(eng, chunk):
    def on_chunk(sup):
        if sup.committed == chunk:
            st = eng.state
            lh = st.lock_holder.clone()
            lh[0] = 99
            eng.state = st._replace(lock_holder=lh)

    return on_chunk


@pytest.mark.parametrize("guard", ["off", "warn", "fail"])
def test_guard_against_a_corrupted_lock_holder(guard):
    eng = _port("solo")
    jeng = _jax("solo")

    def j_corrupt(sup):
        if sup.committed == 2:
            st = jeng.state
            jeng.state = st._replace(lock_holder=st.lock_holder.at[0].set(99))

    sup = t_sup.RunSupervisor(eng, guard=guard, on_chunk=_corrupt_at(eng, 2))
    jsup = j_sup.RunSupervisor(jeng, guard=guard, on_chunk=j_corrupt)
    if guard == "fail":
        with pytest.raises(t_sup.GuardViolation, match="lock_holder") as te:
            sup.run()
        with pytest.raises(j_sup.GuardViolation) as je:
            jsup.run()
        assert str(te.value) == str(je.value)
        assert sup.committed == jsup.committed == 2
        return
    sup.run()  # lock-free trace: the corruption is inert
    jsup.run()
    assert eng.done()
    assert sup.guard_warnings == jsup.guard_warnings
    assert (sup.guard_warnings > 0) == (guard == "warn")
    assert any("guard-warn" in ln for ln in sup.log_lines()) == (guard == "warn")


@pytest.mark.parametrize("gen", ["barrier_phases", "lock_contention"])
def test_guard_fail_passes_clean_sync_runs_and_live_mask_is_jax(gen):
    """No false positives on sync-heavy runs (barrier-frozen cores lag
    quantum_end legally); the solo live mask equals the JAX engine's at
    every chunk boundary."""
    tr = (synth.barrier_phases(8, n_phases=3, seed=5) if gen == "barrier_phases"
          else synth.lock_contention(8, n_critical=8, seed=42))
    eng = Engine(port_cfg(_cfg()), port_trace(tr), chunk_steps=8, device="cpu")
    jeng = JEngine(_cfg(), tr, chunk_steps=8)
    masks = []
    t_sup.RunSupervisor(eng, guard="fail",
                        on_chunk=lambda s: masks.append(eng.live_mask())).run()
    while not jeng.done():
        jeng.run_steps(8)
        np.testing.assert_array_equal(masks.pop(0), jeng.live_mask())
    assert eng.done() and not masks


# ---- disk pressure ----------------------------------------------------------


def _disk(monkeypatch, free):
    """shutil.disk_usage reporting `free` bytes, in both modules."""
    def fake(path):
        return shutil._ntuple_diskusage(1 << 40, (1 << 40) - free, free)

    monkeypatch.setattr(t_dp.shutil, "disk_usage", fake)
    monkeypatch.setattr(j_dp.shutil, "disk_usage", fake)


def test_preflight_passes_with_room(tmp_path, monkeypatch):
    _disk(monkeypatch, 1 << 30)
    before = dict(t_dp.stats)
    t_dp.preflight(str(tmp_path / "x.npz"), 1 << 20)
    assert t_dp.stats["preflights"] == before["preflights"] + 1
    assert t_dp.stats["pressure_events"] == before["pressure_events"]


def test_ladder_runs_evictors_then_compactors_then_raises_the_jax_text(tmp_path, monkeypatch):
    _disk(monkeypatch, 1 << 20)  # 1 MiB free: below the 8 MiB headroom
    order = []
    t_dp.register_evictor("b-snap", lambda n: order.append("snap"), priority=1)
    t_dp.register_evictor("a-cache", lambda n: order.append("cache"), priority=0)
    t_dp.register_compactor("journal", lambda: order.append("compact"))
    path = str(tmp_path / "ckpt.npz")
    with pytest.raises(t_dp.DiskPressureError) as te:
        t_dp.preflight(path, 4096, kind="checkpoint")
    with pytest.raises(j_dp.DiskPressureError) as je:
        j_dp.preflight(path, 4096, kind="checkpoint")
    assert str(te.value) == str(je.value)
    assert te.value.location() == je.value.location() == {"need_bytes": 4096, "path": path}
    assert te.value.retry_after_s == 2.0
    assert order == ["cache", "snap", "compact"]  # the cache-lru rung ran too
    # typed backpressure: the window heals, so a dispatch that meets it
    # backs off and retries, in both packages
    assert t_sup.classify_failure(te.value) == j_sup.classify_failure(je.value) == "transient"

    # an evictor that frees the disk ends the ladder at its rung
    t_dp._EVICTORS.clear()
    t_dp._COMPACTORS.clear()
    t_dp.register_evictor("freer", lambda n: _disk(monkeypatch, 1 << 30), priority=1)
    t_dp.preflight(path, 4096)


def test_rejected_atomic_save_leaves_no_debris(tmp_path, monkeypatch):
    _disk(monkeypatch, 0)
    d = tmp_path / "ck"
    d.mkdir()
    with pytest.raises(t_dp.DiskPressureError):
        t_ck.atomic_save_npz(str(d / "c.npz"), a=np.arange(1000))
    assert os.listdir(d) == []


def test_cache_budget_bounds_the_warm_cache(tmp_path):
    root = tmp_path / "warm"
    root.mkdir()
    for i in range(3):
        (root / f"{i}.npz").write_bytes(b"x" * 1000)
        (root / f"{i}.json").write_text("{}")
        os.utime(root / f"{i}.npz", (i, i))
    t_dp.configure(budget_bytes=2500)
    assert t_ck.prune_warm_cache(str(root)) == 1
    assert sorted(os.listdir(root)) == ["1.json", "1.npz", "2.json", "2.npz"]


def test_supervised_run_under_disk_pressure_skips_every_rotation(tmp_path, monkeypatch):
    _disk(monkeypatch, 0)
    eng = _port("solo")
    sup = t_sup.RunSupervisor(eng, snapshot_dir=str(tmp_path / "ck"),
                              checkpoint_every_chunks=1)
    sup.run()
    assert sup.checkpoints_written == 0 and os.listdir(tmp_path / "ck") == []
    skipped = [ln for ln in sup.log_lines() if "disk-pressure: snapshot skipped" in ln]
    assert len(skipped) == sup.committed + 1  # every rotation and the final one
    _equal("solo", eng)


# ---- the CLI ----------------------------------------------------------------


def _write_cfg(tmp_path):
    p = str(tmp_path / "m.json")
    with open(p, "w") as f:
        f.write(MachineConfig(n_cores=8, n_banks=8).to_json())
    return p


def _last_json(capsys):
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return lines[-1]


def test_cli_supervised_run_and_resume_equal_primetpu(tmp_path, capsys):
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    cfg = _write_cfg(tmp_path)
    run = ["run", cfg, "--synth", "fft_like:n_phases=2,points_per_core=12",
           "--chunk-steps", "16"]
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    rpt = str(tmp_path / "r.txt")
    assert jax_main(run + ["--checkpoint-dir", jck, "--checkpoint-every", "1",
                           "--guard", "fail"]) == 0
    jd = _last_json(capsys)["detail"]
    assert main(run + ["--checkpoint-dir", ck, "--checkpoint-every", "1",
                       "--guard", "fail", "--report", rpt, "--device", "cpu"]) == 0
    td = _last_json(capsys)["detail"]
    assert td["device"] == "cpu" and td["steps"] > 0
    for k in ("instructions", "max_core_cycles", "noc_msgs", "supervised",
              "committed_chunks", "checkpoints_written", "retries", "guard",
              "guard_warnings", "stalled_elements", "degrade_rungs"):
        assert td[k] == jd[k], k
    assert set(jd) - {"wall_s", "exec_cache"} <= set(td)
    text = open(rpt).read()
    assert "RESILIENCE" in text and "checkpoint: ckpt-00000001.npz" in text
    assert sorted(os.listdir(ck)) == sorted(os.listdir(jck))
    assert len(os.listdir(ck)) == 3 and td["checkpoints_written"] > 3

    # tear the newest snapshot: --resume falls back past it and finishes
    snaps = t_sup.SnapshotStore(ck).snapshots()
    blob = open(snaps[0], "rb").read()
    with open(snaps[0], "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert main(run + ["--checkpoint-dir", ck, "--resume", "--device", "cpu"]) == 0
    rd = _last_json(capsys)["detail"]
    assert rd["resumed_from"] == snaps[1]
    for k in ("instructions", "max_core_cycles", "noc_msgs"):
        assert rd[k] == jd[k], k


def test_cli_resume_requires_checkpoint_dir(tmp_path):
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    cfg = _write_cfg(tmp_path)
    for flags in (["--resume"], ["--checkpoint-every", "2"], ["--checkpoint-wall", "5"]):
        with pytest.raises(SystemExit) as je:
            jax_main(["run", cfg, "--synth", "fft_like", *flags])
        with pytest.raises(SystemExit) as te:
            main(["run", cfg, "--synth", "fft_like", *flags, "--device", "cpu"])
        assert str(te.value) == str(je.value) and "--checkpoint-dir" in str(te.value)
    with pytest.raises(SystemExit, match="do not compose with the supervised"):
        main(["run", cfg, "--synth", "fft_like", "--guard", "warn",
              "--debug-invariants", "--device", "cpu"])


def test_cli_preempted_run_exits_75_with_the_preempted_line(tmp_path, capsys, monkeypatch):
    from primesim_tpu_torch.cli import main

    real = t_sup.RunSupervisor.__init__

    def killing(self, *a, **kw):
        real(self, *a, **kw)
        self.on_chunk = _kill_at(2)

    monkeypatch.setattr(t_sup.RunSupervisor, "__init__", killing)
    cfg = _write_cfg(tmp_path)
    ck = str(tmp_path / "ck")
    rc = main(["run", cfg, "--synth", "fft_like:n_phases=2,points_per_core=12",
               "--chunk-steps", "16", "--checkpoint-dir", ck, "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 75 and "preempted: preempted by SIGTERM" in out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["metric"] == "preempted" and line["detail"]["signal"] == signal.SIGTERM
    assert line["detail"]["checkpoint"] == os.path.join(ck, "ckpt-00000001.npz")
    assert line["detail"]["committed_chunks"] == 2
