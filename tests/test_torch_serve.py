"""The port's serving daemon (`primesim_tpu_torch/serve/`, the fleet's
slot surgery, the element checkpoints, the chaos crashpoints, and the
CLI's `serve`, `submit` and `serve-status`) against the JAX package, on
the CPU, mirroring tests/test_serve.py.

Shape discipline as there: `small_test_config(4)` with (2 slots x 1 page)
buckets and chunk_steps 16. Every served job's result record (per-core
cycles, every counter, steps, and under `attest="chain"` its chain head)
equals a solo JAX Engine run of its workload at the same cadence (run
once per workload for the module). The scheduler routes by capacity,
runs an oversized job's leading window in a small bucket and promotes it
by checkpoint, times out, quarantines bad and oversized workloads and
step-budget overruns, pushes back on a full queue, cancels, serves
clients round-robin within a priority tier, rolls a bucket back after a
failed dispatch, and recovers from an abandoned scheduler or a killed
daemon with every accepted job DONE and unchanged; a JAX-written journal
folds to the same job table in both packages and replays into the port's
daemon. The daemon runs in a thread (socket round trip, backpressure on
the wire, SIGHUP reload, metrics) and as a subprocess (a chaos crashpoint
that kills it after its first checkpoint, and SIGTERM, which drains with
exit 75), each with a hard deadline and torn down in a finaliser.
Integer simulator: every tolerance is 0.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from primesim_tpu.config.machine import small_test_config
from primesim_tpu.serve import Job as JJob
from primesim_tpu.serve import JobJournal as JJournal
from primesim_tpu.serve import fold_records as j_fold
from primesim_tpu.serve.scheduler import parse_synth_spec as j_parse
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.fleet import apply_overrides as j_apply
from primesim_tpu_torch import chaos
from primesim_tpu_torch.serve import (
    Job,
    JobJournal,
    JournalCorrupt,
    Scheduler,
    fold_records,
)
from primesim_tpu_torch.serve.client import ServeClient, ServeError
from primesim_tpu_torch.serve.scheduler import QueueFull
from primesim_tpu_torch.serve.server import PrimeServer

from test_torch_engine import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_SYNTH = "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed={}"
#: 103 events/core: needs 2 pages (>64, <=128), runs for several chunks
LONG_SYNTH = "fft_like:n_phases=2,points_per_core=24,ins_per_mem=4,seed={}"
#: 205 events/core, 224 steps: long enough to be caught mid-flight
KILL_SYNTH = "fft_like:n_phases=3,points_per_core=32,ins_per_mem=4,seed={}"
CHUNK = 16
DEADLINE_S = 120  # hard wall limit of every server and subprocess below


def _cfg():
    return port_cfg(small_test_config(4))


def _sched(tmp_path, name="srv", buckets=((2, 1),), **kw):
    d = str(tmp_path / name)
    kw.setdefault("chunk_steps", CHUNK)
    kw.setdefault("max_queue", 16)
    kw.setdefault("device", "cpu")
    return Scheduler(_cfg(), JobJournal(d), d, buckets=buckets, **kw)


def _job(i, synth=SMALL_SYNTH, **kw):
    return Job(job_id=f"j{i:06d}", synth=synth.format(i), **kw)


def _run_all(sched, jobs, limit=5000):
    n = 0
    while not all(j.terminal for j in jobs):
        sched.tick()
        n += 1
        assert n < limit, [j.state for j in jobs]


@functools.lru_cache(maxsize=None)
def jax_solo(spec, ov_json="{}", chunk_steps=CHUNK):
    """A solo JAX Engine run of a served workload, with its chain: the
    parts of a result record a served job is held to."""
    from primesim_tpu.attest import SoloAttest

    cfg = j_apply(small_test_config(4), json.loads(ov_json))
    eng = JEngine(cfg, j_parse(spec, 4, True), chunk_steps=chunk_steps)
    eng.attest = SoloAttest(chunk_steps)
    eng.run_chunked()
    return {
        "core_cycles": [int(c) for c in eng.cycles],
        "counters": {k: [int(x) for x in v] for k, v in eng.counters.items()},
        "steps": int(eng.steps_run),
        "attest": eng.attest.payload(),
    }


def assert_result_is_jax(job, attest=False):
    want = jax_solo(job.synth, json.dumps(job.overrides, sort_keys=True))
    r = job.result
    assert r["core_cycles"] == want["core_cycles"], job.job_id
    assert r["counters"] == want["counters"], job.job_id
    assert r["steps"] == want["steps"] and r["cycles"] == max(want["core_cycles"])
    assert r["instructions"] == sum(want["counters"]["instructions"])
    if attest:
        assert r["attest"] == want["attest"], job.job_id
    else:
        assert "attest" not in r


# ---- journal (a copy of the JAX module) ----------------------------------


def test_journal_roundtrip_and_torn_tail(tmp_path):
    d = str(tmp_path / "wal")
    j = JobJournal(d)
    j.accept(_job(1))
    j.state("j000001", "RUNNING", detail={"attempt": 1})
    j.state("j000001", "DONE", result={"cycles": 42})
    j.close()
    recs, dropped = JobJournal(d).replay()
    assert dropped == 0 and [r["t"] for r in recs] == ["accept", "state", "state"]
    jobs, clean = fold_records(recs)
    assert jobs["j000001"].state == "DONE" and jobs["j000001"].result == {"cycles": 42}
    assert not clean
    with open(JobJournal(d).path, "a") as f:
        f.write('{"c": 1, "r": {"t": "accept"')  # a torn tail: no newline
    recs2, dropped2 = JobJournal(d).replay()
    assert len(recs2) == 3 and dropped2 == 1


def test_journal_midfile_corruption_raises(tmp_path):
    d = str(tmp_path / "wal")
    j = JobJournal(d)
    j.note("one")
    j.note("two")
    j.close()
    lines = open(j.path).read().splitlines()
    lines[0] = lines[0].replace("one", "eno")  # CRC now fails, line 2 valid
    with open(j.path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(JournalCorrupt):
        JobJournal(d).replay()


def test_journal_ack_is_durable(tmp_path):
    d = str(tmp_path / "wal")
    JobJournal(d).accept(_job(7))
    recs, _ = JobJournal(d).replay()  # the writer was never closed
    assert recs and recs[0]["job"]["job_id"] == "j000007"


def test_journal_written_by_jax_folds_alike_in_both_packages(tmp_path):
    """A JAX-written journal (accepts, a redispatch, a duplicate terminal,
    a drain) replays in the port's journal and folds to the same table."""
    d = str(tmp_path / "wal")
    jj = JJournal(d)
    for i in range(3):
        jj.accept(JJob(job_id=f"j{i:06d}", synth=SMALL_SYNTH.format(i), priority=i))
    jj.state("j000000", "RUNNING", detail={"attempt": 1})
    jj.state("j000000", "DONE", result={"cycles": 7})
    jj.state("j000001", "RUNNING", detail={"attempt": 1})
    jj.state("j000000", "DONE", result={"cycles": 999})
    jj.drain()
    jj.close()
    jrecs, jdrop = JJournal(d).replay()
    trecs, tdrop = JobJournal(d).replay()
    assert trecs == jrecs and tdrop == jdrop == 0
    jjobs, jclean = j_fold(jrecs)
    tjobs, tclean = fold_records(trecs)
    assert tclean == jclean
    assert {k: (v.state, v.result, v.priority) for k, v in tjobs.items()} == {
        k: (v.state, v.result, v.priority) for k, v in jjobs.items()}
    assert tjobs["j000000"].result == {"cycles": 7}
    assert tjobs["j000001"].state == "PENDING"


def test_fold_records_first_terminal_wins_under_duplicates():
    job = _job(3)
    acc = {"t": "accept", "job": job.accept_record()}
    run = {"t": "state", "job_id": job.job_id, "state": "RUNNING"}
    done = {"t": "state", "job_id": job.job_id, "state": "DONE", "result": {"cycles": 1}}
    late = {"t": "state", "job_id": job.job_id, "state": "DONE", "result": {"cycles": 9}}
    jobs, clean = fold_records([acc, run, done, acc, run, late])
    assert jobs[job.job_id].state == "DONE" and jobs[job.job_id].result == {"cycles": 1}
    assert not clean
    assert fold_records([acc, run])[0][job.job_id].state == "PENDING"
    jobs3, clean3 = fold_records([run, acc, {"t": "drain"}])
    assert jobs3[job.job_id].state == "PENDING" and clean3
    assert not fold_records([{"t": "drain"}, acc])[1]


def test_claim_socket_path_unlinks_stale_refuses_live(tmp_path):
    import socket as socketmod

    from primesim_tpu_torch.serve.protocol import claim_socket_path, socket_alive

    path = str(tmp_path / "srv.sock")
    s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
    s.bind(path)
    s.close()
    assert os.path.exists(path) and not socket_alive(path)
    claim_socket_path(path)
    assert not os.path.exists(path)
    srv = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(1)
        with pytest.raises(RuntimeError, match="live server"):
            claim_socket_path(path)
        assert os.path.exists(path)
    finally:
        srv.close()


def test_job_state_machine_and_accept_record():
    job = _job(1)
    job.transition("RUNNING")
    job.transition("DONE")
    assert job.terminal and job.latency_s is not None
    with pytest.raises(ValueError):
        job.transition("RUNNING")
    job2 = _job(2)
    with pytest.raises(ValueError):
        job2.transition("DONE")
    job3 = _job(3, deadline_s=9.5, priority=2, client="alice")
    back = Job.from_accept_record(json.loads(json.dumps(job3.accept_record())))
    assert (back.job_id, back.deadline_s, back.priority, back.client, back.state) == (
        "j000003", 9.5, 2, "alice", "PENDING")
    # the accept record is the JAX package's, field for field
    jj = JJob(job_id="j000003", synth=job3.synth, deadline_s=9.5, priority=2, client="alice",
              accepted_t=job3.accepted_t)
    assert job3.accept_record() == jj.accept_record()


# ---- scheduler: continuous batching against JAX solo runs ------------------


@pytest.mark.parametrize("attest", ["off", "chain"])
def test_scheduler_results_equal_jax_solo_runs(attest, tmp_path):
    """More jobs than slots, each with its own timing overrides, drained
    through the continuous-batching loop: every result record equals a
    solo JAX Engine run of its workload, the chain head included."""
    sched = _sched(tmp_path, attest=attest)
    jobs = [_job(i, overrides=ov) for i, ov in enumerate(
        ({}, {"llc_lat": 20}, {"link_lat": 2}, {"quantum": 500}, {}))]
    for j in jobs:
        sched.submit(j)
    _run_all(sched, jobs)
    for j in jobs:
        assert j.state == "DONE"
        assert_result_is_jax(j, attest=attest == "chain")
    s = sched.stats()
    assert (s["completed"], s["queue_depth"], s["slots"]["occupied"]) == (5, 0, 0)
    assert s["latency_s"]["p50"] is not None


def test_scheduler_bucket_routing(tmp_path):
    sched = _sched(tmp_path, buckets=((2, 1), (1, 2)))
    small, large = _job(1), _job(2, synth=LONG_SYNTH)
    sched.submit(small)
    sched.submit(large)
    assert large._trace.max_len > sched.buckets[0].capacity
    sched.tick()
    assert sched.buckets[0].slots[0] is small and sched.buckets[1].slots[0] is large
    _run_all(sched, [small, large])
    for j in (small, large):
        assert j.state == "DONE"
        assert_result_is_jax(j)


def test_window_admission_promotes_by_checkpoint_bit_exact(tmp_path):
    """The large bucket is busy, so a 2-page job starts in a free 1-page
    slot on its leading window and migrates up by element checkpoint
    before the window edge: its result equals the full run's."""
    sched = _sched(tmp_path, buckets=((1, 1), (1, 2)), chunk_steps=8)
    blocker, windowed = _job(1, synth=LONG_SYNTH), _job(2, synth=LONG_SYNTH)
    sched.submit(blocker)
    sched.tick()
    sched.submit(windowed)
    sched.tick()
    assert sched.buckets[0].slots[0] is windowed and windowed._window is not None
    _run_all(sched, [blocker, windowed])
    assert sched.promotions >= 1
    for j in (blocker, windowed):
        assert j.state == "DONE"
    want = jax_solo(windowed.synth, chunk_steps=8)
    assert windowed.result["core_cycles"] == want["core_cycles"]
    assert windowed.result["counters"] == want["counters"]


def test_scheduler_crash_recovery_bit_exact(tmp_path):
    """Abandon a scheduler mid-flight (no drain, no close), replay its
    journal into a fresh one and finish: every accepted job equals the
    JAX solo run, the chain of a job resumed from its element
    checkpoint included."""
    d = str(tmp_path / "srv")
    s1 = Scheduler(_cfg(), JobJournal(d), d, buckets=((2, 2),), chunk_steps=CHUNK,
                   checkpoint_every_s=0.0, attest="chain", device="cpu")
    jobs1 = [_job(i, synth=LONG_SYNTH) for i in range(3)]
    for j in jobs1:
        s1.submit(j)
    for _ in range(3):
        s1.tick()
    assert any(os.path.exists(s1.job_ckpt_path(j.job_id)) for j in jobs1)
    del s1
    wal = JobJournal(d)
    records, dropped = wal.replay()
    jobs, clean = fold_records(records)
    assert dropped == 0 and not clean and len(jobs) == 3
    s2 = Scheduler(_cfg(), wal, d, buckets=((2, 2),), chunk_steps=CHUNK, attest="chain",
                   device="cpu")
    for job in jobs.values():
        (s2.adopt_terminal if job.terminal else s2.requeue_recovered)(job)
    assert any(j._resume_from for j in s2.jobs.values())
    _run_all(s2, list(s2.jobs.values()))
    for j in s2.jobs.values():
        assert j.state == "DONE"
        assert_result_is_jax(j, attest=True)


def test_chaos_crashpoint_then_recovery_bit_exact(tmp_path):
    """The `scheduler.post-checkpoint` crashpoint (raise mode) stops the
    scheduler right after its first element checkpoints; a fresh one on
    the same directory finishes every job equal to the JAX runs."""
    d = str(tmp_path / "srv")
    plan = chaos.FaultPlan(seed=0, events=(chaos.FaultEvent(
        "scheduler.post-checkpoint", 1, "kill"),))
    s1 = Scheduler(_cfg(), JobJournal(d), d, buckets=((2, 2),), chunk_steps=CHUNK,
                   checkpoint_every_s=0.0, attest="chain", device="cpu")
    jobs1 = [_job(i, synth=LONG_SYNTH) for i in range(2)]
    with chaos.active(plan) as rt:
        for j in jobs1:
            s1.submit(j)
        with pytest.raises(chaos.ChaosCrash):
            _run_all(s1, jobs1)
    assert rt.injected and all(not j.terminal for j in jobs1)
    wal = JobJournal(d)
    jobs, _ = fold_records(wal.replay()[0])
    s2 = Scheduler(_cfg(), wal, d, buckets=((2, 2),), chunk_steps=CHUNK, attest="chain",
                   device="cpu")
    for job in jobs.values():
        s2.requeue_recovered(job)
    assert all(j._resume_from for j in s2.jobs.values())
    _run_all(s2, list(s2.jobs.values()))
    for j in s2.jobs.values():
        assert j.state == "DONE"
        assert_result_is_jax(j, attest=True)


def test_failed_dispatch_rolls_the_bucket_back(tmp_path):
    """A chunk that fails with a transient error rolls the whole bucket
    back (an all-idle fleet), re-enqueues its occupants from their
    checkpoints with a retry spent, and the jobs still finish equal."""
    sched = _sched(tmp_path, buckets=((2, 2),), checkpoint_every_s=0.0)
    jobs = [_job(i, synth=LONG_SYNTH) for i in range(2)]
    for j in jobs:
        sched.submit(j)
    sched.tick()
    fleet = sched.buckets[0].fleet
    real = fleet.step_chunk

    def fail():
        real()
        raise RuntimeError("UNAVAILABLE: injected after a real chunk")

    fleet.step_chunk = fail
    sched.tick()
    assert sched.buckets[0].fleet is not fleet and sched.buckets[0].occupied == 0
    assert all(j.state == "PENDING" and j._resume_from for j in jobs)
    sched._backoff_until = 0.0
    _run_all(sched, jobs)
    for j in jobs:
        assert j.state == "DONE" and j.attempts == 2
        assert_result_is_jax(j)


def test_element_checkpoint_rejected_by_solo_loader(tmp_path):
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.serve.scheduler import parse_synth_spec

    sched = _sched(tmp_path, buckets=((2, 2),), checkpoint_every_s=0.0)
    job = Job(job_id="j000001", synth=LONG_SYNTH.format(1))
    sched.submit(job)
    sched.tick()
    ck = sched.job_ckpt_path(job.job_id)
    assert os.path.exists(ck)
    eng = Engine(_cfg(), parse_synth_spec(job.synth, 4, True), chunk_steps=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="element checkpoint"):
        eng.load_checkpoint(ck)


# ---- deadlines, budgets, quarantine, backpressure, cancel ------------------


def test_deadlines_in_queue_and_while_running(tmp_path):
    sched = _sched(tmp_path, buckets=((2, 2),))
    queued = _job(1, deadline_s=0.0)
    running = _job(2, synth=LONG_SYNTH, deadline_s=0.05)
    sched.submit(queued)
    sched.submit(running)
    sched.tick()
    assert queued.state == "TIMEOUT" and "deadline" in queued.detail["detail"]
    time.sleep(0.06)
    _run_all(sched, [running], limit=100)
    assert running.state == "TIMEOUT"
    assert sched.stats()["slots"]["occupied"] == 0


def test_step_budget_quarantines(tmp_path):
    sched = _sched(tmp_path, buckets=((2, 2),))
    job = _job(1, synth=LONG_SYNTH, max_steps=16)
    sched.submit(job)
    _run_all(sched, [job], limit=100)
    assert job.state == "QUARANTINED" and job.detail["type"] == "StepBudget"


def test_bad_and_oversized_workloads_are_quarantined(tmp_path):
    sched = _sched(tmp_path)
    bad = Job(job_id="j000001", synth="no_such_generator:x=1")
    sched.submit(bad)
    assert bad.state == "QUARANTINED"
    assert set(bad.detail) >= {"type", "location", "detail"}
    assert "no_such_generator" in bad.detail["detail"]
    big = _job(2, synth=LONG_SYNTH)
    sched.submit(big)
    assert big.state == "QUARANTINED" and big.detail["type"] == "CapacityError"
    jobs, _ = fold_records(sched.journal.replay()[0])
    assert jobs["j000001"].state == jobs["j000002"].state == "QUARANTINED"


def test_backpressure_queue_full(tmp_path):
    sched = _sched(tmp_path, max_queue=2)
    sched.submit(_job(1))
    sched.submit(_job(2))
    with pytest.raises(QueueFull) as ei:
        sched.submit(_job(3))
    assert ei.value.retry_after_s > 0
    jobs, _ = fold_records(sched.journal.replay()[0])
    assert len(jobs) == 2


def test_cancel_pending_running_and_unknown(tmp_path):
    sched = _sched(tmp_path, buckets=((1, 2),))
    running, pending = _job(1, synth=LONG_SYNTH), _job(2)
    sched.submit(running)
    sched.submit(pending)
    sched.tick()
    assert running.state == "RUNNING"
    sched.cancel(pending.job_id)
    sched.cancel(running.job_id)
    assert pending.state == running.state == "CANCELLED"
    assert sched.stats()["slots"]["occupied"] == 0 and not sched.queue
    with pytest.raises(KeyError):
        sched.cancel("nope")
    with pytest.raises(ValueError):
        sched.cancel(running.job_id)


def _running_order(sched):
    recs, _ = sched.journal.replay()
    return [r["job_id"] for r in recs if r["t"] == "state" and r["state"] == "RUNNING"]


def test_per_client_fairness_and_priority(tmp_path):
    sched = _sched(tmp_path, buckets=((1, 1),))
    a = [_job(i, client="a") for i in range(3)]
    b = _job(9, client="b")
    for j in a + [b]:
        sched.submit(j)
    _run_all(sched, a + [b])
    assert _running_order(sched)[:2] == [a[0].job_id, b.job_id]
    sched2 = _sched(tmp_path, "srv2", buckets=((1, 1),))
    lo, hi = _job(1, priority=0), _job(2, priority=5)
    sched2.submit(lo)
    sched2.submit(hi)
    _run_all(sched2, [lo, hi])
    assert _running_order(sched2)[0] == hi.job_id


# ---- the daemon in a thread ------------------------------------------------


@pytest.fixture
def server_thread(tmp_path):
    """Start a PrimeServer's serve loop in a thread; the finaliser drains
    it and joins within the deadline."""
    started = []

    def start(**kw):
        kw.setdefault("buckets", ((2, 1),))
        kw.setdefault("chunk_steps", CHUNK)
        kw.setdefault("device", "cpu")
        server = PrimeServer(_cfg(), state_dir=str(tmp_path / "srv"), **kw)
        box = {}
        t = threading.Thread(target=lambda: box.update(rc=server.serve_forever()), daemon=True)
        t.start()
        deadline = time.time() + DEADLINE_S
        while not os.path.exists(server.socket_path):
            assert time.time() < deadline and t.is_alive()
            time.sleep(0.01)
        started.append((server, t, box))
        return server, t, box

    yield start
    for server, t, _ in started:
        server._draining = server._stop = True
        t.join(timeout=DEADLINE_S)
        assert not t.is_alive()


def test_server_socket_roundtrip(server_thread):
    server, t, box = server_thread(checkpoint_every_s=60.0, attest="chain")
    cli = ServeClient(server.socket_path, timeout_s=60.0)
    job = cli.submit(synth=SMALL_SYNTH.format(3), client="t", overrides={"llc_lat": 20})
    assert job["job_id"] == "j000001" and job["state"] == "PENDING"
    done = cli.wait(job["job_id"], timeout_s=DEADLINE_S)
    assert done["state"] == "DONE"
    want = jax_solo(SMALL_SYNTH.format(3), json.dumps({"llc_lat": 20}))
    assert done["result"]["core_cycles"] == want["core_cycles"]
    assert done["result"]["counters"] == want["counters"]
    assert done["result"]["attest"] == want["attest"]
    health = cli.health()
    assert health["completed"] == 1 and health["queue_depth"] == 0
    assert health["journal"]["appends"] > 0 and "recovered" in health
    assert health["device"]["fleet_steps"] >= done["result"]["steps"]
    text = cli.metrics()
    samples = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    assert all(len(ln.rsplit(" ", 1)) == 2 for ln in samples)
    assert "primetpu_jobs" in text and 'le="+Inf"' in text
    with pytest.raises(ServeError, match="unknown job"):
        cli.status("j999999")
    with pytest.raises(ServeError):
        cli.cancel(job["job_id"])
    cli.drain()
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive() and box["rc"] == 0


def test_server_backpressure_retry_after_on_wire(tmp_path):
    server = PrimeServer(_cfg(), state_dir=str(tmp_path / "srv"), buckets=((2, 1),),
                         chunk_steps=CHUNK, max_queue=1, device="cpu")
    listener = server._make_listener()
    t = threading.Thread(target=listener.serve_forever, daemon=True)
    t.start()
    stop = threading.Event()

    def pump():  # the inbox without the tick loop: admitted jobs stay queued
        while not stop.is_set():
            server._drain_inbox()
            time.sleep(0.005)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        cli = ServeClient(server.socket_path, timeout_s=30.0)
        cli.submit(synth=SMALL_SYNTH.format(1))
        with pytest.raises(ServeError) as ei:
            cli.submit(synth=SMALL_SYNTH.format(2))
        assert ei.value.retry_after_s is not None
        assert ei.value.error["type"] == "QueueFull"
    finally:
        stop.set()
        listener.shutdown()
        listener.server_close()
        pumper.join(timeout=10)
        server.journal.close()


def test_sighup_reload_keeps_the_geometry(tmp_path):
    import dataclasses

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_cfg().to_json())
    server = PrimeServer(_cfg(), state_dir=str(tmp_path / "srv"), buckets=((2, 1),),
                         chunk_steps=CHUNK, config_path=str(cfg_path), device="cpu")
    cfg_path.write_text(dataclasses.replace(_cfg(), fault_seed=7).to_json())
    server.reload_config()
    assert server.sched.cfg.fault_seed == 7
    cfg_path.write_text(small_test_config(8).to_json())
    server.reload_config()
    assert server.sched.cfg.n_cores == 4
    notes = [r["msg"] for r in server.journal.replay()[0] if r["t"] == "note"]
    assert any("REJECTED" in m for m in notes)
    server.journal.close()


def test_jax_state_directory_replays_into_the_port_daemon(tmp_path):
    """A JAX scheduler's state directory (journal + element checkpoints
    of an abandoned run) restarts in the port's daemon, which finishes
    every job equal to the JAX solo runs."""
    from primesim_tpu.serve.scheduler import Scheduler as JSched

    d = str(tmp_path / "srv")
    js = JSched(small_test_config(4), JJournal(d), d, buckets=((2, 2),), chunk_steps=CHUNK,
                checkpoint_every_s=0.0)
    jobs = [JJob(job_id=f"j{i:06d}", synth=LONG_SYNTH.format(i)) for i in range(2)]
    for j in jobs:
        js.submit(j)
    js.tick()
    js.tick()
    del js
    server = PrimeServer(_cfg(), state_dir=d, buckets=((2, 2),), chunk_steps=CHUNK,
                         device="cpu")
    assert server.recovered["jobs_requeued"] == 2
    assert all(j._resume_from for j in server.sched.jobs.values())
    _run_all(server.sched, list(server.sched.jobs.values()))
    for j in server.sched.jobs.values():
        assert j.state == "DONE"
        assert_result_is_jax(j)
    server.journal.close()


def test_service_report_section():
    from primesim_tpu_torch.stats.counters import COUNTER_NAMES
    from primesim_tpu_torch.stats.report import render_report

    cfg = _cfg()
    txt = render_report(
        cfg, {k: np.zeros(cfg.n_cores, np.int64) for k in COUNTER_NAMES},
        np.zeros(cfg.n_cores, np.int64), title="primetpu serve",
        service={"jobs_completed": 3, "jobs_by_state": {"DONE": 3, "TIMEOUT": 1},
                 "aggregate_mips": 1.25, "latency_s": {"p50": 0.5, "p90": 1.0, "p99": None},
                 "uptime_s": 12.0},
    )
    assert "SERVICE" in txt and "jobs completed" in txt and "1.250" in txt
    assert "timeout" in txt and "latency p90" in txt and "p99" not in txt


# ---- the CLI and the daemon as a subprocess --------------------------------


def test_cli_submit_and_status_without_a_server_exit_1(tmp_path, capsys):
    from primesim_tpu_torch.cli import main

    sock = str(tmp_path / "nope.sock")
    assert main(["submit", "--socket", sock, "--synth", "uniform:n_mem_ops=1"]) == 1
    assert main(["serve-status", "--socket", sock]) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert all(not o["ok"] for o in out) and len(out) == 2


def _spawn(tmp_path, env_extra=None, idle_exit=None, state="state", buckets="2x4",
           checkpoint_wall=0.2):
    """The port's `serve` as a subprocess on the CPU; returns (process,
    socket) once a health round trip succeeds."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_cfg().to_json())
    sock = str(tmp_path / state / "serve.sock")
    argv = ["serve", str(cfg_path), "--state-dir", str(tmp_path / state), "--buckets", buckets,
            "--chunk-steps", str(CHUNK), "--checkpoint-wall", str(checkpoint_wall),
            "--attest", "chain",
            "--device", "cpu"]
    if idle_exit is not None:
        argv += ["--idle-exit", str(idle_exit)]
    code = ("import sys; from primesim_tpu_torch.cli import main; "
            "sys.exit(main(%r))" % (argv,))
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    deadline = time.time() + DEADLINE_S
    probe = ServeClient(sock, timeout_s=5.0)
    while True:
        if proc.poll() is not None:
            raise AssertionError("server died at startup: "
                                 + proc.stderr.read().decode()[-2000:])
        if os.path.exists(sock):
            try:
                probe.health()
                return proc, sock
            except OSError:
                pass
        if time.time() > deadline:
            proc.kill()
            raise AssertionError("server never became ready")
        time.sleep(0.1)


@pytest.fixture
def procs():
    """Processes started by a test: killed in the finaliser."""
    started = []
    yield started
    for p in started:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=DEADLINE_S)


def _finish(proc):
    out, err = proc.communicate(timeout=DEADLINE_S)
    return proc.returncode, err.decode()


def test_daemon_killed_after_its_first_checkpoint_loses_nothing(tmp_path, procs):
    """PRIMETPU_CHAOS_PLAN kills the daemon (SIGKILL) at its first
    `scheduler.post-checkpoint`; a restart on the same state directory
    replays the journal and finishes every accepted job equal to the JAX
    solo runs, chains included (resumed from the element checkpoints)."""
    plan = tmp_path / "plan.json"
    plan.write_text(chaos.FaultPlan(seed=0, events=(chaos.FaultEvent(
        "scheduler.post-checkpoint", 1, "kill"),)).to_json())
    # the first periodic checkpoint comes a second after the daemon starts,
    # when the jobs submitted at once are running
    proc, sock = _spawn(tmp_path, {"PRIMETPU_CHAOS_PLAN": str(plan),
                                   "PRIMETPU_CHAOS_MODE": "kill"}, checkpoint_wall=1.0)
    procs.append(proc)
    specs = [KILL_SYNTH.format(11), LONG_SYNTH.format(12), SMALL_SYNTH.format(13)]
    # all at once, so that they are admitted before the first checkpoint
    with ThreadPoolExecutor(len(specs)) as pool:
        ids = [f.result()["job_id"] for f in [pool.submit(
            ServeClient(sock, timeout_s=60.0).submit, synth=s, client="c") for s in specs]]
    rc, _ = _finish(proc)
    assert rc == -signal.SIGKILL
    jobs, _ = fold_records(JobJournal(str(tmp_path / "state")).replay()[0])
    assert sorted(jobs) == sorted(ids) and not all(j.terminal for j in jobs.values())
    assert os.listdir(tmp_path / "state" / "jobs")  # the checkpoints it died after
    proc2, sock2 = _spawn(tmp_path, idle_exit=1.0)
    procs.append(proc2)
    cli2 = ServeClient(sock2, timeout_s=60.0)
    results = {i: cli2.wait(i, timeout_s=DEADLINE_S) for i in ids}
    rc2, err2 = _finish(proc2)
    assert rc2 == 0, err2[-2000:]
    assert "recovered=" in err2
    for spec, i in zip(specs, ids):
        r = results[i]
        assert r["state"] == "DONE", r
        want = jax_solo(spec)
        assert r["result"]["core_cycles"] == want["core_cycles"]
        assert r["result"]["counters"] == want["counters"]
        assert r["result"]["attest"] == want["attest"]
    # the journal lost nothing: every accepted job ends DONE in it
    jobs, _ = fold_records(JobJournal(str(tmp_path / "state")).replay()[0])
    assert sorted(jobs) == sorted(ids) and all(j.state == "DONE" for j in jobs.values())


def test_sigterm_drains_with_exit_75_then_a_restart_finishes(tmp_path, procs):
    spec = "fft_like:n_phases=4,points_per_core=64,ins_per_mem=4,seed=21"
    proc, sock = _spawn(tmp_path, buckets="1x10")
    procs.append(proc)
    cli = ServeClient(sock, timeout_s=60.0)
    job_id = cli.submit(synth=spec)["job_id"]
    deadline = time.time() + DEADLINE_S
    while cli.status(job_id)["state"] != "RUNNING":
        assert time.time() < deadline
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    rc, err = _finish(proc)
    assert rc == 75, err[-2000:]
    assert "serve: drained rc=75" in err
    proc2, sock2 = _spawn(tmp_path, idle_exit=1.0, buckets="1x10")
    procs.append(proc2)
    done = ServeClient(sock2, timeout_s=60.0).wait(job_id, timeout_s=DEADLINE_S)
    rc2, err2 = _finish(proc2)
    assert rc2 == 0, err2[-2000:]
    assert done["state"] == "DONE"
    want = jax_solo(spec)
    assert done["result"]["core_cycles"] == want["core_cycles"]
    assert done["result"]["counters"] == want["counters"]
    assert done["result"]["attest"] == want["attest"]


def test_cli_submit_serve_status_against_a_live_daemon(tmp_path, procs, capsys):
    """`submit --wait` prints the wire reply with the result; backpressure
    exits 4; `serve-status` prints health, `--jobs`, `--metrics`, one
    `--watch` line and `--drain`, after which the daemon exits 0."""
    from primesim_tpu_torch.cli import main

    proc, sock = _spawn(tmp_path, buckets="2x1")
    procs.append(proc)
    assert main(["submit", "--socket", sock, "--synth", SMALL_SYNTH.format(5), "--fold",
                 "--vary", "llc_lat=20", "--wait"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["job"]["state"] == "DONE"
    assert out["job"]["result"]["attest"] == jax_solo(
        SMALL_SYNTH.format(5), json.dumps({"llc_lat": 20}))["attest"]
    assert main(["serve-status", "--socket", sock]) == 0
    health = json.loads(capsys.readouterr().out)
    assert health["completed"] == 1
    assert main(["serve-status", "--socket", sock, "--jobs"]) == 0
    assert len(json.loads(capsys.readouterr().out)) == 1
    assert main(["serve-status", "--socket", sock, "--metrics"]) == 0
    assert "primetpu_queue_depth" in capsys.readouterr().out
    assert main(["serve-status", "--socket", sock, "--watch", "--count", "1",
                 "--interval", "0.1"]) == 0
    assert "done=1" in capsys.readouterr().out
    assert main(["serve-status", "--socket", sock, "--drain"]) == 0
    rc, err = _finish(proc)
    assert rc == 0, err[-2000:]


def test_cli_submit_backpressure_exits_4(tmp_path, procs, capsys):
    from primesim_tpu_torch.cli import main

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_cfg().to_json())
    server = PrimeServer(_cfg(), state_dir=str(tmp_path / "srv"), buckets=((2, 1),),
                         chunk_steps=CHUNK, max_queue=0, device="cpu")
    listener = server._make_listener()
    t = threading.Thread(target=listener.serve_forever, daemon=True)
    t.start()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            server._drain_inbox()
            time.sleep(0.005)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        rc = main(["submit", "--socket", server.socket_path, "--synth", SMALL_SYNTH.format(1)])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 4 and out["retry_after_s"] > 0
        assert out["error"]["type"] == "QueueFull"
    finally:
        stop.set()
        listener.shutdown()
        listener.server_close()
        pumper.join(timeout=10)
        server.journal.close()
