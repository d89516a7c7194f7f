"""The port's elastic worker pool (`primesim_tpu_torch/pool/`: units, the
ledger fold and its compactor, the coordinator, the worker, the pooled
sweep and the `worker`/`coordinator` verbs) against the JAX package's
`pool/`, on the CPU, mirroring tests/test_pool.py.

Shape discipline as there: `small_test_config(4)`, chunk_steps 16 (8 for
the crash), a FakeClock for every coordinator so that a lease expires
exactly when the test says. The pure functions (unit keys, units, the
fold, the compactor) are fed the same numpy-seeded inputs in both
packages; one scripted lease sequence (grant, heartbeat, expiry,
re-dispatch, poison, hedge and first ACK, a key mismatch, an audit, a
divergence and its tiebreak) goes through both coordinators, whose
replies and ledgers must be equal but for the pool directory's path; a
ledger either package wrote replays in the other. The port's worker runs
in-process against the real unix socket (the coordinator serves it from
its own threads): its results and chain heads equal the JAX worker's, it
resumes a crashed unit from its element checkpoint (the port's or the
JAX package's) and quarantines a bad unit. One `sweep --workers 2`
subprocess run equals the JAX package's results. Integer simulator:
every tolerance is 0.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from primesim_tpu.config.machine import small_test_config
from primesim_tpu.pool import PoolCoordinator as JCoordinator
from primesim_tpu.pool import PoolWorker as JWorker
from primesim_tpu.pool import SimulatedCrash as JSimulatedCrash
from primesim_tpu.pool import units as JU
from primesim_tpu.serve.journal import JobJournal as JJournal
from primesim_tpu_torch import chaos
from primesim_tpu_torch.pool import PoolCoordinator, PoolWorker, SimulatedCrash
from primesim_tpu_torch.pool import units as U
from primesim_tpu_torch.serve.journal import JobJournal
from primesim_tpu_torch.serve.protocol import request

from test_torch_engine import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_SYNTH = "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed={}"
#: several chunks at chunk_steps=8 — room to crash at chunk 2 and resume
CRASH_SYNTH = "fft_like:n_phases=2,points_per_core=16,ins_per_mem=4,seed={}"
# the result fields a wall clock moves
WALL_FIELDS = ("value",)
WALL_DETAIL = ("wall_s",)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _units(pkg, n=2, synth=SMALL_SYNTH, chunk_steps=16, ovs=None):
    cfg = small_test_config(4) if pkg is JU else port_cfg(small_test_config(4))
    return pkg.build_units(
        cfg, [], [synth.format(i) for i in range(n)],
        ovs or [{} for _ in range(n)],
        fold=True, chunk_steps=chunk_steps, max_steps=100_000,
    )


def _stable(result):
    """A unit result without the fields a wall clock moves."""
    if result is None:
        return None
    r = {k: v for k, v in result.items() if k not in WALL_FIELDS}
    if "detail" in r:
        r["detail"] = {k: v for k, v in r["detail"].items() if k not in WALL_DETAIL}
    return r


# ---- pure functions --------------------------------------------------------


def test_units_and_keys_equal_the_jax_package():
    rng = np.random.default_rng(13)
    cfg_j = small_test_config(4)
    cfg_t = port_cfg(cfg_j)
    for _ in range(8):
        n = int(rng.integers(1, 5))
        synths = [SMALL_SYNTH.format(int(s)) for s in rng.integers(0, 99, n)]
        traces = [f"/data/t{int(s)}.ptpu" for s in rng.integers(0, 9, int(rng.integers(0, 3)))]
        ovs = [{k: int(rng.integers(1, 40)) for k in rng.choice(
            ["llc_lat", "link_lat", "quantum", "dram_lat"], int(rng.integers(0, 3)),
            replace=False)} for _ in range(len(traces) + n)]
        kw = dict(fold=bool(rng.integers(2)), chunk_steps=int(rng.integers(1, 64)),
                  max_steps=int(rng.integers(1, 10**6)), warm_cache=bool(rng.integers(2)))
        devices = int(rng.choice([0, 0, 2]))
        ju = JU.build_units(cfg_j, traces, synths, ovs, devices=devices, **kw)
        tu = U.build_units(cfg_t, traces, synths, ovs, devices=devices, **kw)
        assert tu == ju
        for u in tu:
            assert U.unit_key(u) == JU.unit_key(u) == u["key"]
        seg = dict(seg_events=int(rng.integers(1, 5000)), n_segments=int(rng.integers(1, 6)),
                   chunk_steps=int(rng.integers(0, 64)))
        src = ("/data/big.ptpu", None) if rng.integers(2) else (None, synths[0])
        assert (U.build_ingest_units(cfg_t, *src, **seg)
                == JU.build_ingest_units(cfg_j, *src, **seg))
    with pytest.raises(ValueError, match="fan rule"):
        U.build_units(cfg_t, [], [SMALL_SYNTH.format(0)], [{}, {}],
                      fold=True, chunk_steps=16, max_steps=100)
    with pytest.raises(ValueError, match="exactly one"):
        U.build_ingest_units(cfg_t, None, None, 4, 1)


def _record_stream(rng, n):
    """A seeded pool ledger: every record type, duplicated acks, acks
    before their leases, expiries after acks, poison beside results,
    attestation flows and drain markers anywhere."""
    heads = ["a" * 64, "b" * 64, "c" * 64]
    recs = []
    for _ in range(n):
        uid = f"u{int(rng.integers(0, 4)):05d}"
        w = f"w{int(rng.integers(0, 4))}"
        e = int(rng.integers(0, 6))
        at = {"head": heads[int(rng.integers(0, 3))], "chunks": 2, "start": 0,
              "chunk_steps": 16}
        t = rng.choice(["unit", "lease", "expire", "ack", "ack", "ack_dup", "suspect",
                        "verdict", "audit", "poison", "note", "drain"])
        if t == "unit":
            recs.append({"t": "unit", "unit": {"unit_id": uid, "key": "k" + uid}})
        elif t == "lease":
            recs.append({"t": "lease", "unit_id": uid, "worker": w, "epoch": e,
                         "key": "k" + uid, "hedge": bool(rng.integers(2))})
        elif t == "expire":
            recs.append({"t": "expire", "unit_id": uid, "worker": w, "epoch": e})
        elif t in ("ack", "ack_dup"):
            r = {"t": t, "unit_id": uid, "worker": w, "epoch": e, "key": "k" + uid,
                 "result": {"v": int(rng.integers(0, 3))},
                 "resumed_steps": int(rng.integers(0, 64))}
            if rng.integers(2):
                r["attest"] = at
            if t == "ack_dup" and rng.integers(2):
                r["audit"] = True
            recs.append(r)
        elif t == "suspect":
            recs.append({"t": "suspect", "unit_id": uid, "key": "k" + uid,
                         "workers": [w, "w9"], "held": [{"worker": w, "attest": at}]})
        elif t == "verdict":
            if rng.integers(2):
                recs.append({"t": "verdict", "unit_id": uid, "outcome": "resolved",
                             "worker": w, "epoch": e, "result": {"v": 7},
                             "resumed_steps": 0, "attest": at, "quarantined": ["w9"]})
            else:
                recs.append({"t": "verdict", "unit_id": uid, "outcome": "unresolved",
                             "held": [{"worker": w}]})
        elif t == "audit":
            recs.append({"t": "audit", "unit_id": uid, "worker": w,
                         "ok": [True, False, None][int(rng.integers(0, 3))]})
        elif t == "poison":
            recs.append({"t": "poison", "unit_id": uid, "key": "k" + uid,
                         "kills": [w, "w8"]})
        elif t == "note":
            recs.append({"t": "note", "msg": "x"})
        else:
            recs.append({"t": "drain"})
        if rng.integers(4) == 0:  # a redelivered duplicate
            recs.append(copy.deepcopy(recs[-1]))
    return recs


@pytest.mark.parametrize("seed", range(6))
def test_fold_and_compactor_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    recs = _record_stream(rng, int(rng.integers(5, 60)))
    if seed % 2:
        recs.append({"t": "drain"})  # a clean end
    for stream in (recs, recs[::-1], [recs[i] for i in rng.permutation(len(recs))]):
        assert U.fold_unit_records(copy.deepcopy(stream)) == \
            JU.fold_unit_records(copy.deepcopy(stream))
        assert U.pool_compactor(copy.deepcopy(stream)) == \
            JU.pool_compactor(copy.deepcopy(stream))


# ---- one scripted lease sequence through both coordinators -----------------


def _norm(reply, pool_dir):
    """A reply with the pool directory's path taken out, and a refusal's
    error kept to its type (the toolchain fields are each package's)."""
    r = json.loads(json.dumps(reply).replace(pool_dir, "<pool>"))
    if r.get("refused"):
        r["error"] = {"type": r["error"]["type"]}
    return r


def _script(Coord, units, pool_dir, attest):
    """Drive one coordinator through the scripted sequence over four
    units; returns its replies and its results."""
    clk = FakeClock()
    coord = Coord(copy.deepcopy(units), pool_dir, lease_ttl_s=5.0,
                  poison_threshold=2, hedge=True, clock=clk,
                  attest="chain" if attest else "off",
                  audit_rate=1.0 if attest else 0.0)
    out = []

    def call(req):
        out.append(_norm(coord.handle(req), pool_dir))
        return out[-1]

    def lease(w):
        return call({"verb": "lease", "worker": w})

    def beat(w, g):
        return call({"verb": "heartbeat", "worker": w, "unit_id": g["unit"]["unit_id"],
                     "epoch": g["epoch"], "steps": 32})

    def ack(w, g, head):
        u = g["unit"]
        req = {"verb": "ack", "worker": w, "unit_id": u["unit_id"], "epoch": g["epoch"],
               "key": u["key"], "result": {"metric": "x", "value": w}, "resumed_steps": 3,
               "attest": {"head": head * 64, "chunks": 2, "start": 0, "chunk_steps": 16}}
        if g.get("audit"):
            req["audit"] = True
        return call(req)

    def expire_all_but(keep):
        # the other leases go silent past their TTL; `keep`'s is renewed
        clk.advance(3.0)
        beat(*keep)
        clk.advance(3.0)
        coord.tick()

    try:
        g0, g1 = lease("w0"), lease("w1")
        beat("w0", g0)
        expire_all_but(("w0", g0))  # w1 dies: u1's lease expires
        call({"verb": "status"})
        g1b = lease("w2")  # re-dispatch of u1, epoch 2
        call({"verb": "heartbeat", "worker": "w1", "unit_id": "u00001", "epoch": 1})
        call({"verb": "ack", "worker": "w0", "unit_id": "u00000", "epoch": 1,
              "key": "deadbeefdeadbeef", "result": {}, "resumed_steps": 0})
        ack("w0", g0, "a")
        ack("w3", lease("w3"), "b")  # u2
        lease("w4")  # u3, which kills w4 and then w5: poison
        expire_all_but(("w2", g1b))
        lease("w5")
        expire_all_but(("w2", g1b))
        if attest:
            ack("w6", lease("w6"), "a")  # the audit of u0 agrees
            ack("w7", lease("w7"), "c")  # the audit of u2 diverges
            ack("w8", lease("w8"), "b")  # the tiebreak: w7 refuted
            lease("w7")  # refused: quarantined as suspect
        gh = lease("w9")  # a hedge twin of the straggler u1
        ack("w9", gh, "d")  # first ack wins
        ack("w2", g1b, "d")  # the loser: a duplicate (a confirmation)
        if attest:
            ack("w10", lease("w10"), "d")  # the audit of u1
        lease("w11")  # done
        call({"verb": "status"})
        call({"verb": "enqueue", "unit": {"unit_id": "x"}})  # no source: error
        call({"verb": "collect"})
        results = coord.results()
    finally:
        coord.close()
    return out, results


def _ledger(Journal, pool_dir):
    j = Journal(pool_dir)
    try:
        return j.replay()[0]
    finally:
        j.close()


@pytest.mark.parametrize("attest", [False, True], ids=["plain", "attest"])
def test_scripted_coordinators_reply_and_journal_alike(tmp_path, attest):
    ju = _units(JU, 4)
    tu = _units(U, 4)
    assert ju == tu
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jout, jres = _script(JCoordinator, ju, jd, attest)
    tout, tres = _script(PoolCoordinator, tu, td, attest)
    assert len(tout) == len(jout)
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t == j, (i, t, j)
    assert tres == jres
    assert _ledger(JobJournal, td) == _ledger(JJournal, jd)
    # the script reached every branch it names
    kinds = {r["t"] for r in _ledger(JobJournal, td)}
    want = {"lease", "expire", "ack", "ack_dup", "poison"}
    if attest:
        want |= {"unit", "audit", "suspect", "verdict"}
    assert want <= kinds, kinds
    st = [r for r in tout if "counters" in r][-1]
    assert st["done"] and st["units"]["POISON"] == 1 and st["units"]["DONE"] == 3
    c = st["counters"]
    assert c["redispatches"] == 2 and c["hedges"] == 1 and c["poisoned"] == 1
    if attest:
        assert (c["audits"], c["audits_ok"], c["attest_mismatches"]) == (3, 2, 1)
        assert c["verdicts"] == 1 and c["suspects"] == 1 and c["attest_confirms"] == 3


def test_attested_lease_refuses_another_toolchain(tmp_path):
    from primesim_tpu_torch.attest import toolchain_fingerprint

    coord = PoolCoordinator(_units(U, 1), str(tmp_path / "pool"), attest="chain")
    try:
        ours = toolchain_fingerprint()
        assert coord.handle({"verb": "lease", "worker": "w0", "toolchain": ours})["unit"]
        bad = coord.handle({"verb": "lease", "worker": "w1",
                            "toolchain": {**ours, "kernels": "0" * 64}})
        assert bad["refused"] == "toolchain" and not bad["ok"]
        assert "kernels" in bad["error"]["detail"]
        assert coord.stats()["counters"]["toolchain_refused"] == 1
    finally:
        coord.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_ledger_replays_in_the_other_package(tmp_path, writer):
    """One package's coordinator acks a unit and holds a lease on the
    other when it is killed (no drain); the other package's coordinator
    on the same directory adopts the result and re-adopts the lease by
    the worker's heartbeat."""
    W, R = (JCoordinator, PoolCoordinator) if writer == "jax" else (PoolCoordinator, JCoordinator)
    units = _units(U, 2)
    pool_dir = str(tmp_path / "pool")
    clk = FakeClock()
    c1 = W(copy.deepcopy(units), pool_dir, hedge=False, clock=clk)
    g0 = c1.handle({"verb": "lease", "worker": "w0"})
    u0 = g0["unit"]
    assert c1.handle({"verb": "ack", "worker": "w0", "unit_id": u0["unit_id"],
                      "epoch": g0["epoch"], "key": u0["key"], "result": {"v": "kept"},
                      "resumed_steps": 0})["accepted"]
    g1 = c1.handle({"verb": "lease", "worker": "w1"})
    c1.close()

    c2 = R(copy.deepcopy(units), pool_dir, hedge=False, clock=clk)
    try:
        assert c2.recovered["results_adopted"] == 1
        assert c2.recovered["stale_entries"] == 0
        assert c2.results()[0]["result"] == {"v": "kept"}
        hb = c2.handle({"verb": "heartbeat", "worker": "w1",
                        "unit_id": g1["unit"]["unit_id"], "epoch": g1["epoch"]})
        assert hb["ok"] and not hb.get("lost")
        assert c2.stats()["counters"]["readoptions"] == 1
        assert c2.handle({"verb": "ack", "worker": "w1", "unit_id": g1["unit"]["unit_id"],
                          "epoch": g1["epoch"], "key": g1["unit"]["key"],
                          "result": {"v": 1}, "resumed_steps": 0})["accepted"]
        assert c2.done
    finally:
        c2.close()


# ---- the worker, in-process over the real socket ---------------------------


@functools.lru_cache(maxsize=None)
def jax_campaign(synth, n, chunk_steps):
    """The JAX worker's results for an n-unit campaign under attest chain
    (its in-process run, as tests/test_pool.py drives it)."""
    import tempfile

    units = _units(JU, n, synth=synth, chunk_steps=chunk_steps)
    with tempfile.TemporaryDirectory(prefix="jpool") as d:
        coord = JCoordinator(units, d, lease_ttl_s=30.0, attest="chain")
        coord.start()
        try:
            w = JWorker(coord.socket_path, "jw", reconnect_timeout_s=10.0)
            assert w.run() == 0
            return [(r["unit_id"], r["state"], _stable(r["result"]), r["resumed_steps"])
                    for r in coord.results()]
        finally:
            coord.close()


def test_worker_campaign_equals_the_jax_worker(tmp_path):
    units = _units(U, 2)
    coord = PoolCoordinator(units, str(tmp_path / "pool"), lease_ttl_s=30.0,
                            attest="chain")
    coord.start()
    try:
        w = PoolWorker(coord.socket_path, "w0", reconnect_timeout_s=10.0, device="cpu")
        assert w.run() == 0
        assert w.units_done == 2 and coord.done
        got = [(r["unit_id"], r["state"], _stable(r["result"]), r["resumed_steps"])
               for r in coord.results()]
        assert got == jax_campaign(SMALL_SYNTH, 2, 16)
        assert all(r[2]["detail"]["attest"]["head"] for r in got)
        # results are durable; unit checkpoints are gone (dead weight)
        assert os.listdir(os.path.join(coord.pool_dir, "units")) == []
    finally:
        coord.close()


def _crash_then_resume(tmp_path, Coord, crasher, resumer_pkg_is_port=True):
    clk = FakeClock()
    units = _units(U, 1, synth=CRASH_SYNTH, chunk_steps=8)
    pool_dir = str(tmp_path / "pool")
    coord = Coord(copy.deepcopy(units), pool_dir, hedge=False, clock=clk, attest="chain")
    coord.start()
    try:
        g = request(coord.socket_path, {"verb": "lease", "worker": "wA"})
        crasher(coord.socket_path, g)
        ckpt = os.path.join(pool_dir, "units", "u00000.npz")
        assert os.path.exists(ckpt)  # chunk 2 committed before the kill
    finally:
        coord.close()
    # the restarted coordinator: the port's, whoever wrote the ledger
    c2 = PoolCoordinator(copy.deepcopy(units), pool_dir, hedge=False, clock=clk,
                         attest="chain")
    c2.start()
    try:
        clk.advance(6.0)
        c2.tick()
        wb = PoolWorker(c2.socket_path, "wB", reconnect_timeout_s=10.0, device="cpu")
        assert wb.run() == 0
        r = c2.results()[0]
        assert r["state"] == "DONE"
        assert r["resumed_steps"] == 16  # resumed at chunk 2, not step 0
        want = jax_campaign(CRASH_SYNTH, 1, 8)[0]
        assert _stable(r["result"]) == want[2]  # the chain head included
        assert not os.path.exists(ckpt)  # reaped on ack
        return c2.stats()
    finally:
        c2.close()


def test_worker_crash_resumes_its_checkpoint_equal_to_jax(tmp_path):
    def crash(sock, g):
        wa = PoolWorker(sock, "wA", reconnect_timeout_s=10.0, crash_after_chunks=2,
                        simulate_crash=True, device="cpu")
        try:
            with pytest.raises(SimulatedCrash):
                wa.run_unit(g)
        finally:
            chaos.deactivate()

    _crash_then_resume(tmp_path, PoolCoordinator, crash)


def test_port_worker_resumes_a_jax_worker_checkpoint(tmp_path):
    from primesim_tpu.chaos import sites as jchaos

    def crash(sock, g):
        wa = JWorker(sock, "wA", reconnect_timeout_s=10.0, crash_after_chunks=2,
                     simulate_crash=True)
        try:
            with pytest.raises(JSimulatedCrash):
                wa.run_unit(g)
        finally:
            jchaos.deactivate()

    _crash_then_resume(tmp_path, JCoordinator, crash)


def test_worker_quarantines_a_bad_unit_and_a_multi_device_unit(tmp_path):
    units = _units(U, 2)
    units[0]["synth"] = "no_such_kernel:oops=1"
    units[0]["key"] = U.unit_key(units[0])
    units[1]["devices"] = 2
    units[1]["key"] = U.unit_key(units[1])
    coord = PoolCoordinator(units, str(tmp_path / "pool"))
    coord.start()
    try:
        w = PoolWorker(coord.socket_path, "w0", reconnect_timeout_s=10.0, device="cpu")
        assert w.run() == 0
        r0, r1 = coord.results()
        for r in (r0, r1):
            assert r["state"] == "DONE" and r["result"]["metric"] == "quarantined"
            assert r["result"]["detail"]["status"] == "quarantined"
        assert r0["result"]["detail"]["error"]["type"] == "WorkloadSpecError"
        assert r1["result"]["detail"]["error"]["type"] == "MultiDeviceNotPorted"
        assert r1["result"]["detail"]["error"]["location"] == {"devices": 2}
    finally:
        coord.close()


def test_worker_without_a_card_refuses_to_simulate(tmp_path, monkeypatch):
    """No card and no `device="cpu"`: the worker raises at its first
    simulated unit (the `worker` verb exits non-zero), never falling back
    to the CPU; the unit stays leased for another worker."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coord = PoolCoordinator(_units(U, 1), str(tmp_path / "pool"), hedge=False)
    coord.start()
    try:
        w = PoolWorker(coord.socket_path, "w0", reconnect_timeout_s=5.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            w.run()
        assert w.device is None and coord.stats()["units"]["LEASED"] == 1
    finally:
        coord.close()


# ---- the pooled sweep, a subprocess ----------------------------------------


def _write_cfg(tmp_path):
    p = str(tmp_path / "cfg.json")
    with open(p, "w") as f:
        f.write(small_test_config(4).to_json())
    return p


def test_cli_pooled_sweep_equals_the_jax_results(tmp_path):
    cfg_path = _write_cfg(tmp_path)
    cmd = [sys.executable, "-m", "primesim_tpu_torch", "sweep", cfg_path,
           "--synth", SMALL_SYNTH.format(0), "--synth", SMALL_SYNTH.format(1),
           "--fold", "--chunk-steps", "16", "--workers", "2", "--device", "cpu",
           "--attest", "chain", "--pool-dir", str(tmp_path / "pool"),
           "--report", str(tmp_path / "report.txt")]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    elems = [row for row in rows if row["metric"] == "simulated_MIPS"]
    want = jax_campaign(SMALL_SYNTH, 2, 16)
    assert [_stable(e) for e in elems] == [w[2] for w in want]
    agg = rows[-1]
    assert agg["metric"] == "fleet_aggregate_MIPS"
    assert agg["detail"]["pool"]["units_done"] == 2
    assert "POOL" in open(tmp_path / "report.txt").read().splitlines()
    # each worker names its device and, at exit, its kernel launches
    for wid in ("w0", "w1"):
        assert f"worker {wid}: pid" in r.stderr
        assert f"worker {wid}: exit 0" in r.stderr
    assert "(cpu), kernels loaded" in r.stderr


def test_cli_pool_flag_refusals():
    from primesim_tpu_torch.cli import main

    base = ["sweep", os.path.join(REPO, "configs", "rung1_64core_fft.json"),
            "--synth", "fft_like", "--device", "cpu"]
    for extra, msg in ((["--report", "r.txt"], "--report is the pooled"),
                       (["--workers", "2", "--strict"], "--strict is not supported"),
                       (["--workers", "2", "--fork-prefix", "auto"], "--fork-prefix needs"),
                       (["--workers", "2", "--guard", "warn"], "--checkpoint-")):
        with pytest.raises(SystemExit, match=msg):
            main(base + extra)


def test_worker_and_pooled_sweep_processes_without_a_card_exit_nonzero(tmp_path):
    """On this card-less host: a `worker` process not given `--device
    cpu` leases a unit and exits non-zero at it (its exit line still
    printed), leaving the unit leased; a pooled sweep not given
    `--device cpu` fails before it spawns a worker."""
    coord = PoolCoordinator(_units(U, 1), str(tmp_path / "pool"), hedge=False)
    coord.start()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "primesim_tpu_torch", "worker", "--connect",
             coord.socket_path, "--worker-id", "w0", "--reconnect-timeout", "5"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert "worker w0: exit raised" in r.stderr
        assert coord.stats()["units"]["LEASED"] == 1
    finally:
        coord.close()
    r = subprocess.run(
        [sys.executable, "-m", "primesim_tpu_torch", "sweep", _write_cfg(tmp_path),
         "--synth", SMALL_SYNTH.format(0), "--workers", "2",
         "--pool-dir", str(tmp_path / "pool2")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "worker w0" not in r.stderr and r.stdout == ""


def test_pool_events_reach_the_trace_and_the_report_section(tmp_path):
    from primesim_tpu_torch.obs import Recorder
    from primesim_tpu_torch.stats.counters import COUNTER_NAMES
    from primesim_tpu_torch.stats.report import render_report

    clk = FakeClock()
    rec = Recorder("full")
    coord = PoolCoordinator(_units(U, 1), str(tmp_path / "pool"), lease_ttl_s=5.0,
                            hedge=False, clock=clk, obs=rec)
    try:
        coord.handle({"verb": "lease", "worker": "w0"})
        clk.advance(6.0)
        coord.tick()  # expire
        g = coord.handle({"verb": "lease", "worker": "w1"})  # redispatch
        coord.handle({"verb": "ack", "worker": "w1", "unit_id": "u00000",
                      "epoch": g["epoch"], "key": g["unit"]["key"], "result": {"v": 1},
                      "resumed_steps": 0})
        kinds = {e["name"] for e in rec.trace.events if e["ph"] == "i"}
        assert {"lease", "expire", "redispatch", "ack"} <= kinds
        text = render_report(port_cfg(small_test_config(4)),
                             {k: np.zeros(4, dtype=np.int64) for k in COUNTER_NAMES},
                             np.zeros(4, dtype=np.int64), pool=coord.pool_report())
        lines = text.splitlines()
        assert "POOL" in lines

        def row(label):
            return next(ln for ln in lines if ln.startswith(f"  {label}"))

        assert row("units done").endswith(" 1") and row("expired leases").endswith(" 1")
        assert row("redispatches").endswith(" 1") and row("units poisoned").endswith(" 0")
    finally:
        coord.close()
