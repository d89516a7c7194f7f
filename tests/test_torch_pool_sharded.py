"""The port's sharded pool units and serving buckets (`pool/worker.py`'s
`_unit_mesh` and its re-lease, `sweep --workers --devices`, the
dispatcher's `devices` buckets and `_rebucket_devices`) against the JAX
package, on the CPU.

The shards all live on the CPU; their count is the suite's 8 XLA_FLAGS
devices. The JAX package's pure decisions are compared directly: the
mesh size `_unit_mesh` grants (full, re-leased after revocations, or a
DeviceMeshError when nothing is left), the unit key with `devices`, and
the journal records a rebucket writes when both dispatchers are fed the
same quarantined DeviceMeshError (visible 3). The port's sharded runs are
held to the JAX package's UNSHARDED results on the same seeds (JAX's own
GSPMD meshes are slow-marked in its suite): a worker's full grant, its
re-lease on a smaller mesh after a revocation (booked in the
coordinator's ledger as `devices_requested`/`devices_granted`), a
sharded unit resumed from its element checkpoint on a smaller granted
mesh, a pooled `sweep --workers 2 --devices 4` and a job served by a
`devices` bucket. Unsharded units keep their keys and records: no
`devices` keys appear. Integer simulator: every tolerance is 0.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading
import time

import jax
import pytest
import torch

from primesim_tpu.config.machine import small_test_config
from primesim_tpu.parallel import sharding as j_sharding
from primesim_tpu.pool import PoolWorker as JWorker
from primesim_tpu.pool import units as JU
from primesim_tpu.serve import Job as JJob
from primesim_tpu.serve import JobJournal as JJournal
from primesim_tpu.serve.dispatch import DispatchScheduler as JDispatch
from primesim_tpu_torch import chaos
from primesim_tpu_torch.parallel import sharding
from primesim_tpu_torch.pool import PoolCoordinator, PoolWorker, SimulatedCrash
from primesim_tpu_torch.pool import units as U
from primesim_tpu_torch.serve import Job, JobJournal
from primesim_tpu_torch.serve.dispatch import DispatchScheduler
from primesim_tpu_torch.serve.protocol import request

from test_torch_engine import port_cfg
from test_torch_pool import CRASH_SYNTH, SMALL_SYNTH, FakeClock, _stable, _units, jax_campaign
from test_torch_serve import DEADLINE_S, jax_solo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see test_torch_sharding)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _healthy_pool():
    yield
    sharding.restore_devices()
    j_sharding.restore_devices()
    chaos.deactivate()


def _sharded(units, devices):
    for u in units:
        u["devices"] = devices
        u["key"] = U.unit_key(u)
    return units


def _without_devices(result):
    r = copy.deepcopy(result)
    for k in ("devices", "devices_granted"):
        r["detail"].pop(k, None)
    return r


# ---- the pure decisions ----------------------------------------------------------


@pytest.mark.parametrize("cores,banks,asked", [(8, 8, 8), (16, 4, 4), (8, 8, 2)])
def test_unit_mesh_grants_and_releases_as_the_jax_worker(cores, banks, asked):
    """test_degrade.py:303: a full grant while enough healthy devices
    remain, else a re-lease on the largest valid smaller mesh recorded on
    the unit, and JAX's DeviceMeshError once none is left: the same
    granted size as the JAX worker's after every revocation."""
    jcfg = small_test_config(cores, n_banks=banks)
    tcfg = port_cfg(jcfg)
    jw = JWorker(socket_path="/nonexistent.sock", worker_id="jw")
    tw = PoolWorker(socket_path="/nonexistent.sock", worker_id="tw", device="cpu")
    for revoked in range(8):
        j_sharding.restore_devices()
        sharding.restore_devices()
        j_sharding.revoke_devices([d.id for d in jax.devices()[8 - revoked:]])
        sharding.revoke_devices(range(8 - revoked, 8))
        ju, tu = {"devices": asked}, {"devices": asked}
        jm, tm = jw._unit_mesh(ju, jcfg), tw._unit_mesh(tu, tcfg)
        assert tu == ju, revoked
        assert tm.size == len(jm.devices.flatten()), revoked
        assert tm.ids == [d.id for d in jm.devices.flatten()], revoked
    assert tw.units_degraded == jw.units_degraded > 0
    j_sharding.revoke_devices([d.id for d in jax.devices()])
    sharding.revoke_devices(range(8))
    with pytest.raises(j_sharding.DeviceMeshError) as je:
        jw._unit_mesh({"devices": asked}, jcfg)
    with pytest.raises(sharding.DeviceMeshError) as te:
        tw._unit_mesh({"devices": asked}, tcfg)
    assert str(te.value) == str(je.value) and te.value.location() == je.value.location()
    assert tw._unit_mesh({}, tcfg) is None  # an unsharded unit asks for no mesh


def test_unit_keys_with_and_without_devices_equal_the_jax_package():
    for devices in (0, 2, 4):
        ju, tu = _units(JU, 2), _units(U, 2)
        if devices:
            ju = [dict(u, devices=devices) for u in ju]
            tu = _sharded(tu, devices)
        for j, t in zip(ju, tu):
            assert U.unit_key(t) == JU.unit_key(j)
            assert ("devices" in t) == bool(devices)


# ---- the worker -----------------------------------------------------------------


def test_worker_full_grant_and_release_after_a_revocation(tmp_path):
    """Three units asking for 4 devices: the first on the full grant, the
    second, after devices 3-7 are revoked (3 healthy left), on 2 shards
    (devices_granted 2, booked in the ledger as devices_requested 4,
    devices_granted 2), the third after the devices heal on 4 again.
    Every result is the JAX package's unsharded one; only the records of
    sharded units carry `devices` keys."""
    units = _sharded(_units(U, 3), 4)
    coord = PoolCoordinator(units, str(tmp_path / "pool"), lease_ttl_s=30.0, attest="chain")
    coord.start()
    w = PoolWorker(coord.socket_path, "w0", reconnect_timeout_s=10.0, device="cpu")
    try:
        for i in range(3):
            if i == 1:
                sharding.revoke_devices(range(3, 8))
            if i == 2:
                sharding.restore_devices()
            w.run_unit(request(coord.socket_path, {"verb": "lease", "worker": "w0"}))
        assert coord.done and w.units_done == 3 and w.units_degraded == 1
        got = [_stable(r["result"]) for r in coord.results()]
        assert [r["detail"].get("devices_granted") for r in got] == [None, 2, None]
        assert all(r["detail"]["devices"] == 4 for r in got)
        want = jax_campaign(SMALL_SYNTH, 3, 16)
        assert [_without_devices(r) for r in got] == [x[2] for x in want]
        assert coord.stats()["counters"]["capacity_degraded"] == 1
    finally:
        coord.close()
    journal = JobJournal(coord.pool_dir)
    notes = [r for r in journal.replay()[0] if r.get("t") == "note" and r.get("kind") == "capacity"]
    journal.close()
    assert [(n["unit_id"], n["devices_requested"], n["devices_granted"])
            for n in notes] == [("u00001", 4, 2)]


def test_a_sharded_unit_resumes_its_checkpoint_on_a_smaller_granted_mesh(tmp_path):
    """A unit on 4 shards dies after its second committed chunk; all but
    3 devices are revoked; the re-lease resumes the unit's element
    checkpoint on 2 shards from step 16 and finishes with the JAX
    package's result."""
    clk = FakeClock()
    units = _sharded(_units(U, 1, synth=CRASH_SYNTH, chunk_steps=8), 4)
    pool_dir = str(tmp_path / "pool")
    coord = PoolCoordinator(units, pool_dir, hedge=False, clock=clk, attest="chain")
    coord.start()
    try:
        g = request(coord.socket_path, {"verb": "lease", "worker": "wA"})
        wa = PoolWorker(coord.socket_path, "wA", reconnect_timeout_s=10.0,
                        crash_after_chunks=2, simulate_crash=True, device="cpu")
        with pytest.raises(SimulatedCrash):
            wa.run_unit(g)
        chaos.deactivate()
        assert os.path.exists(os.path.join(pool_dir, "units", "u00000.npz"))
        sharding.revoke_devices(range(3, 8))
        clk.advance(11.0)  # past the lease's 10 s: expired and re-dispatched
        coord.tick()
        wb = PoolWorker(coord.socket_path, "wB", reconnect_timeout_s=10.0, device="cpu")
        assert wb.run() == 0 and wb.units_degraded == 1
        r = coord.results()[0]
        assert r["state"] == "DONE" and r["resumed_steps"] == 16
        res = _stable(r["result"])
        assert res["detail"]["devices"] == 4 and res["detail"]["devices_granted"] == 2
        assert _without_devices(res) == jax_campaign(CRASH_SYNTH, 1, 8)[0][2]
    finally:
        coord.close()


def test_cli_pooled_sweep_devices_equals_the_jax_results(tmp_path):
    """`sweep --workers 2 --devices 4`: the workers run every unit on 4
    shards, each element's line the JAX package's unsharded one plus
    `devices`."""
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(small_test_config(4).to_json())
    cmd = [sys.executable, "-m", "primesim_tpu_torch", "sweep", cfg_path,
           "--synth", SMALL_SYNTH.format(0), "--synth", SMALL_SYNTH.format(1),
           "--fold", "--chunk-steps", "16", "--workers", "2", "--devices", "4",
           "--device", "cpu", "--attest", "chain", "--pool-dir", str(tmp_path / "pool")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    elems = [_stable(row) for row in rows if row["metric"] == "simulated_MIPS"]
    assert [e["detail"]["devices"] for e in elems] == [4, 4]
    assert [_without_devices(e) for e in elems] == [w[2] for w in jax_campaign(SMALL_SYNTH, 2, 16)]
    assert rows[-1]["detail"]["pool"]["units_done"] == 2


# ---- the dispatcher ---------------------------------------------------------------


class _Events:
    def __init__(self):
        self.seen = []

    def serve_event(self, kind, args):
        self.seen.append((kind, dict(args)))


def _dispatcher(D, tmp_path, name, devices, **kw):
    d = str(tmp_path / name)
    return D(small_test_config(4) if D is JDispatch else port_cfg(small_test_config(4)),
             (JJournal if D is JDispatch else JobJournal)(d), d, str(tmp_path / f"{name}pool"),
             chunk_steps=16, spawn=False, devices=devices, obs=_Events(),
             **({} if D is JDispatch else {"device": "cpu"}), **kw)


def test_rebucket_records_equal_the_jax_dispatcher(tmp_path):
    """The same quarantined DeviceMeshError record (a worker that sees 3
    devices) fed to both dispatchers of a 4-device bucket: both shrink
    the bucket to 2, re-enqueue the job under the alias j000001r1 (the
    spec and its key equal), journal the same `rebucket` detail and emit
    the same serve event; with a zero capacity both quarantine."""
    err = {"type": "DeviceMeshError", "location": {"devices": 4, "visible": 3},
           "detail": "--devices 4 exceeds the 3 visible device(s)"}
    fin = {"unit_id": "j000001", "state": "DONE", "resumed_steps": 0, "result": {
        "metric": "quarantined", "value": None, "unit": None,
        "detail": {"engine": "fleet", "fleet_index": 1, "status": "quarantined",
                   "overrides": {}, "error": err}}}
    seen = []
    for D, JobCls, name in ((JDispatch, JJob, "j"), (DispatchScheduler, Job, "t")):
        sched = _dispatcher(D, tmp_path, name, 4)
        job = JobCls(job_id="j000001", synth=SMALL_SYNTH.format(1), fold=True)
        sched.submit(job)
        sched.queue.remove(job.job_id)  # dispatched, as a tick would
        sched.dispatched.add(job.job_id)
        sched._finish_remote(sched._job_for_unit("j000001"), copy.deepcopy(fin))
        spec = sched._unit_spec(job)
        sched.journal.close()
        records, _ = (JJournal if D is JDispatch else JobJournal)(str(tmp_path / name)).replay()
        for rec in records:
            rec.pop("ts", None)
            rec.pop("t_wall", None)
        seen.append((job.state, sched.devices, sched.queue, sched.unit_aliases, spec,
                     sched._job_for_unit("j000001r1").job_id, [r for r in records
                     if r.get("t") != "accept"], sched.obs.seen))
    assert seen[1] == seen[0]
    state, devices, queue, aliases, spec = seen[1][:5]
    assert (state, devices, queue, aliases) == ("PENDING", 2, ["j000001"],
                                                {"j000001r1": "j000001"})
    assert spec["unit_id"] == "j000001r1" and spec["devices"] == 2
    assert any(r.get("detail", {}).get("rebucket") == {"devices_from": 4, "devices_to": 2}
               for r in seen[1][6])
    assert ("rebucket", {"job_id": "j000001", "devices_from": 4, "devices_to": 2}) in seen[1][7]
    for D, JobCls, name in ((JDispatch, JJob, "j0"), (DispatchScheduler, Job, "t0")):
        sched = _dispatcher(D, tmp_path, name, 4)
        job = JobCls(job_id="j000001", synth=SMALL_SYNTH.format(1), fold=True)
        sched.submit(job)
        gone = copy.deepcopy(fin)
        gone["result"]["detail"]["error"]["location"]["visible"] = 0
        sched._finish_remote(job, gone)
        assert job.state == "QUARANTINED" and sched.devices == 4
        sched.journal.close()


def test_a_devices_bucket_serves_jax_equal_results(tmp_path):
    """The front-end with a 4-device bucket, a dynamic coordinator and
    one worker thread: the job runs on a 4-shard fleet and its result,
    chain head included, is a solo JAX Engine run's."""
    sched = _dispatcher(DispatchScheduler, tmp_path, "fe", 4, buckets=((2, 1), (2, 4)),
                        poll_every_s=0.0, attest="chain")
    coord = PoolCoordinator([], sched.pool_dir, socket_path=sched.pool_socket,
                            lease_ttl_s=10.0, dynamic=True, attest="chain")
    coord.start()
    w = PoolWorker(sched.pool_socket, "dw", reconnect_timeout_s=10.0, idle_exit_s=1.0,
                   device="cpu")
    t = threading.Thread(target=w.run, daemon=True)
    try:
        job = Job(job_id="j000001", synth=SMALL_SYNTH.format(1), fold=True)
        sched.submit(job)
        t.start()
        deadline = time.monotonic() + DEADLINE_S
        while not job.terminal:
            sched.tick()
            assert time.monotonic() < deadline, job.state
            time.sleep(0.01)
        assert job.state == "DONE", job.detail
        want = jax_solo(job.synth)
        r = job.result
        assert r["core_cycles"] == want["core_cycles"] and r["counters"] == want["counters"]
        assert r["steps"] == want["steps"] and r["attest"] == want["attest"]
        fleet = next(iter(w._bucket_fleets.values()))
        assert fleet.mesh.size == 4 and list(w._bucket_fleets)[0][3] == 4
    finally:
        t.join(timeout=30)
        coord.close()
        sched.journal.close()
