"""The port's dispatching daemon (`serve/dispatch.py`, `serve --pool-dir`)
against the JAX package, on the CPU, mirroring
tests/test_unified_serve.py's dispatch cases.

Admission without processes (`spawn=False`) gives the JAX
DispatchScheduler's unit specs (their keys included), job states and
stats on the same jobs. In-process, the front-end dispatches to a
dynamic coordinator and a worker thread over the real unix socket, and
every served result, under `attest="chain"` its chain head included,
equals a solo JAX Engine run of its workload; a worker-quarantined unit
quarantines its job. One `serve --pool-dir D --workers 2 --device cpu
--attest chain --audit-rate 1.0` subprocess run serves two jobs equal to
their JAX runs, with both audits passed. Integer simulator: every
tolerance is 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from primesim_tpu.config.machine import small_test_config
from primesim_tpu.serve import Job as JJob
from primesim_tpu.serve import JobJournal as JJournal
from primesim_tpu.serve.dispatch import DispatchScheduler as JDispatch
from primesim_tpu.serve.scheduler import QueueFull as JQueueFull
from primesim_tpu_torch.pool import PoolCoordinator, PoolWorker
from primesim_tpu_torch.serve import Job, JobJournal
from primesim_tpu_torch.serve.dispatch import DispatchScheduler
from primesim_tpu_torch.serve.protocol import request
from primesim_tpu_torch.serve.scheduler import QueueFull

from test_torch_engine import port_cfg
from test_torch_serve import DEADLINE_S, SMALL_SYNTH, jax_solo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: 81 events/core: does NOT fit a 1-page (64-event) slot, fits 8 pages
WINDOW_SYNTH = "stream:n_mem_ops=80,seed={}"
CHUNK = 16


def _admit(D, JobCls, journal, d, pool):
    sched = D(
        small_test_config(4) if D is JDispatch else port_cfg(small_test_config(4)),
        journal, d, pool, buckets=((6, 1), (2, 8)), chunk_steps=CHUNK,
        max_queue=2, max_workers=3, lease_ttl_s=5.0, spawn=False,
        **({} if D is JDispatch else {"device": "cpu"}),
    )
    trail = []
    for i, synth in ((1, WINDOW_SYNTH.format(1)), (2, "stream:n_mem_ops=600,seed=2"),
                     (3, WINDOW_SYNTH.format(3))):
        job = JobCls(job_id=f"j{i:06d}", synth=synth)
        sched.submit(job)
        trail.append((job.job_id, job.state, job.detail))
    try:
        sched.submit(JobCls(job_id="j000004", synth=WINDOW_SYNTH.format(4)))
    except (QueueFull, JQueueFull) as e:
        trail.append(("full", str(e), e.retry_after_s))
    spec = sched._unit_spec(sched.jobs["j000001"])
    ticked = sched.tick()
    stats = sched.stats()
    for k in ("uptime_s", "last_dispatch_t", "last_dispatch_age_s", "latency_s"):
        stats.pop(k)
    cancelled = sched.cancel("j000003").state
    left = sched.drain()
    sched.journal.close()
    return trail, spec, ticked, stats, cancelled, left, list(sched.queue)


def test_admission_and_stats_equal_the_jax_dispatcher(tmp_path):
    j = _admit(JDispatch, JJob, JJournal(str(tmp_path / "jf")), str(tmp_path / "jf"),
               str(tmp_path / "jpool"))
    t = _admit(DispatchScheduler, Job, JobJournal(str(tmp_path / "tf")), str(tmp_path / "tf"),
               str(tmp_path / "tpool"))
    assert t == j
    trail, spec, ticked, stats, cancelled, left, queue = t
    assert spec["serve_job"] and spec["unit_id"] == "j000001"
    assert spec["capacity_pages"] == 8  # the smallest ladder page that fits
    assert trail[1][1] == "QUARANTINED" and trail[1][2]["type"] == "CapacityError"
    assert trail[-1][0] == "full" and "queue full (2 pending)" in trail[-1][1]
    assert ticked is False
    assert stats["workers"] == {"live": 0, "max": 3, "spawned": 0,
                                "coordinator_adopted": False}
    assert cancelled == "CANCELLED" and left == 1 and queue == ["j000001"]


def test_dispatch_refuses_a_multi_device_bucket(tmp_path):
    """A bucket whose mesh cannot be had (3 shards of 4 cores, 16 of 8
    visible devices) is refused at bring-up with the JAX dispatcher's
    typed DeviceMeshError; a valid one (2 devices) puts `devices` into
    every unit spec, key included, as the JAX dispatcher does."""
    from primesim_tpu.parallel.sharding import DeviceMeshError as JMeshError
    from primesim_tpu_torch.parallel.sharding import DeviceMeshError

    def make(D, journal, d, devices):
        return D(small_test_config(4) if D is JDispatch else port_cfg(small_test_config(4)),
                 journal, d, str(tmp_path / f"pool{devices}"), spawn=False, devices=devices,
                 **({} if D is JDispatch else {"device": "cpu"}))

    for devices in (3, 16):
        with pytest.raises(JMeshError) as je:
            make(JDispatch, JJournal(str(tmp_path / f"j{devices}")), str(tmp_path / f"j{devices}"),
                 devices)
        with pytest.raises(DeviceMeshError) as te:
            make(DispatchScheduler, JobJournal(str(tmp_path / f"t{devices}")),
                 str(tmp_path / f"t{devices}"), devices)
        assert str(te.value) == str(je.value)
        assert te.value.location() == je.value.location()
    specs = []
    for D, JobCls, Journal, d in ((JDispatch, JJob, JJournal, "j2"),
                                  (DispatchScheduler, Job, JobJournal, "t2")):
        sched = make(D, Journal(str(tmp_path / d)), str(tmp_path / d), 2)
        job = JobCls(job_id="j000001", synth=SMALL_SYNTH.format(1), fold=True)
        sched.submit(job)
        specs.append(sched._unit_spec(sched.jobs["j000001"]))
        sched.journal.close()
    assert specs[1] == specs[0] and specs[1]["devices"] == 2


def _result_is_jax(job):
    want = jax_solo(job.synth, json.dumps(job.overrides, sort_keys=True))
    r = job.result
    assert r["core_cycles"] == want["core_cycles"], job.job_id
    assert r["counters"] == want["counters"], job.job_id
    assert r["steps"] == want["steps"] and r["cycles"] == max(want["core_cycles"])
    assert r["instructions"] == sum(want["counters"]["instructions"])
    assert r["attest"] == want["attest"], job.job_id


def test_dispatch_in_process_serves_jax_equal_results(tmp_path):
    """The front-end, a dynamic coordinator on its pool socket and one
    worker thread: every job DONE with its JAX result and chain head; a
    job whose workload a worker cannot run is quarantined."""
    d, pool = str(tmp_path / "fe"), str(tmp_path / "pool")
    sched = DispatchScheduler(
        port_cfg(small_test_config(4)), JobJournal(d), d, pool,
        buckets=((2, 1), (2, 4)), chunk_steps=CHUNK, spawn=False, poll_every_s=0.0,
        attest="chain", device="cpu")
    coord = PoolCoordinator([], pool, socket_path=sched.pool_socket, lease_ttl_s=10.0,
                            dynamic=True, attest="chain")
    coord.start()
    w = PoolWorker(sched.pool_socket, "dw", reconnect_timeout_s=10.0, idle_exit_s=1.0,
                   device="cpu")
    t = threading.Thread(target=w.run, daemon=True)
    try:
        jobs = [Job(job_id=f"j{i:06d}", synth=SMALL_SYNTH.format(i),
                    overrides=ov, fold=True)
                for i, ov in ((1, {}), (2, {"llc_lat": 20}), (3, {"quantum": 500}))]
        for job in jobs:
            sched.submit(job)
        # a unit the worker cannot run (the front-end's spec with another
        # workload): the worker quarantines it, and its job with it
        bad = Job(job_id="j000009", synth=SMALL_SYNTH.format(9))
        assert coord.handle({"verb": "enqueue", "unit": {
            **sched._unit_spec(jobs[0]), "unit_id": bad.job_id, "synth": "nope:x=1",
            "key": "badbadbadbadbad0"}})["ok"]
        sched.jobs[bad.job_id] = bad
        sched.dispatched.add(bad.job_id)
        t.start()
        deadline = time.monotonic() + DEADLINE_S
        while not all(j.terminal for j in [*jobs, bad]):
            sched.tick()
            assert time.monotonic() < deadline, [j.state for j in jobs]
            time.sleep(0.01)
        for job in jobs:
            assert job.state == "DONE", (job.job_id, job.detail)
            _result_is_jax(job)
        assert bad.state == "QUARANTINED"
        assert bad.detail["type"] == "WorkloadSpecError"
        assert sched.stats()["completed"] == 3 and not sched.pending_work()
        assert coord.stats()["counters"]["acks"] == 4
    finally:
        t.join(timeout=30)
        coord.close()
        sched.journal.close()
    assert not t.is_alive() and w.units_done == 4


def test_cli_dispatching_daemon_serves_jax_equal_results(tmp_path):
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(small_test_config(4).to_json())
    state, pool = str(tmp_path / "st"), str(tmp_path / "pool")
    sock = os.path.join(state, "serve.sock")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "primesim_tpu_torch", "serve", cfg_path,
         "--state-dir", state, "--pool-dir", pool, "--workers", "2",
         "--lease-ttl", "5", "--chunk-steps", str(CHUNK), "--buckets", "2x1",
         "--attest", "chain", "--audit-rate", "1.0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + DEADLINE_S
        while not os.path.exists(sock):
            assert daemon.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        specs = [(SMALL_SYNTH.format(i), ov) for i, ov in ((11, {}), (12, {"link_lat": 2}))]
        subs = [subprocess.Popen(
            [sys.executable, "-m", "primesim_tpu_torch", "submit", "--socket", sock,
             "--synth", s, "--fold", *sum((["--vary", f"{k}={v}"] for k, v in ov.items()), []),
             "--wait", "--timeout", str(DEADLINE_S)],
            cwd=REPO, stdout=subprocess.PIPE, text=True) for s, ov in specs]
        outs = [json.loads(p.communicate(timeout=DEADLINE_S)[0]) for p in subs]
        for out, (s, ov) in zip(outs, specs):
            assert out["ok"] and out["job"]["state"] == "DONE", out
            _result_is_jax(Job(job_id=out["job"]["job_id"], synth=s, overrides=ov,
                               result=out["job"]["result"]))
        # both audits (a second worker re-running each unit) agree
        while True:
            c = request(os.path.join(pool, "pool.sock"), {"verb": "status"})["counters"]
            if c["audits_ok"] == 2 or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert (c["audits"], c["audits_ok"], c["attest_mismatches"]) == (2, 2, 0)
        request(sock, {"verb": "drain"})
        assert daemon.wait(timeout=DEADLINE_S) == 0
        err = daemon.stderr.read()
        assert "(dispatch->" in err and "(cpu), kernels loaded" in err
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
