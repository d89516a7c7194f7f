"""The port's replicated journal and fenced standby failover
(`primesim_tpu_torch/serve/replicate.py`, `serve --replicas/--quorum*/
--standby-of`, the `replica` verb) against the JAX package's
`serve/replicate.py`, on the CPU, mirroring tests/test_replicate.py.

One parametrised test drives each pairing of a primary's sink and its
replicas across the two packages (JAX sink to port replicas, port sink to
JAX replicas, port to port) through two rolls, a compaction and a resync
from the BASE of a replica that was down: every replica's segment chain is
byte-identical to the primary's, and both packages' `fsck --compare` hold
them clean. The JAX package's fast cases then run against the port's
classes: quorum defaults and validation, the block and degrade policies,
catch-up across rolls, fencing on promotion, a deposed primary's tail
discarded, `pull_chain`'s epoch-first order, the epoch kept through
compaction, the full resync after a diverged rolled prefix, and the CLI's
compare exits (equal to `primetpu`'s). The two replication chaos sites
partition, duplicate and delay an order and kill a replica before its
fsync, and the chains still converge. The daemon in a thread refuses
admission below quorum and exits 75 once fenced. One subprocess story runs
two `replica` daemons, a primary `serve --replicas` and a standby
`--standby-of` through `python -m primesim_tpu_torch ... --device cpu`,
kills the primary with SIGKILL and deletes its state directory: the
standby promotes at epoch 2 and serves every job equal to a JAX
FleetEngine run, and `fsck --compare` is clean against each replica.

Everything but that story runs the real wire protocol against in-process
`ReplicaServer` threads on 127.0.0.1. Integer simulator, byte formats:
every comparison is exact.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest

from primesim_tpu.analysis.fsck import run_compare as j_compare
from primesim_tpu.config.machine import small_test_config
from primesim_tpu.serve import replicate as JR
from primesim_tpu.serve.journal import JobJournal as JJournal
from primesim_tpu.serve.journal import serve_compactor as j_compactor
from primesim_tpu_torch.analysis.fsck import run_compare
from primesim_tpu_torch.serve.journal import JobJournal, _frame, _scan_lines, _unframe
from primesim_tpu_torch.serve.journal import serve_compactor
from primesim_tpu_torch.serve.replicate import (
    PrimaryFenced,
    ReplicaQuorumLost,
    ReplicaServer,
    ReplicationSink,
    Standby,
    max_epoch,
    pull_chain,
)

from test_torch_engine import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_SYNTH = "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed={}"
LONG_SYNTH = "fft_like:n_phases=3,points_per_core=32,ins_per_mem=4,seed={}"
CHUNK = 16
DEADLINE_S = 120  # hard wall limit of every daemon and subprocess below

# the three packages' pieces a pairing names: (journal, compactor, sink)
PRIMARY = {"jax": (JJournal, j_compactor, JR.ReplicationSink),
           "port": (JobJournal, serve_compactor, ReplicationSink)}
REPLICA = {"jax": JR.ReplicaServer, "port": ReplicaServer}


def _accept_rec(i):
    from primesim_tpu_torch.serve.jobs import Job

    job = Job(job_id=f"j{i}", synth=SMALL_SYNTH.format(i), client="c", idem=f"t{i}")
    return {"t": "accept", "job": job.accept_record()}


def _chain_bytes(d):
    """{segment filename: content} for every journal file in a dir."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("journal"):
            with open(os.path.join(d, name)) as f:
                out[name] = f.read()
    return out


def _replicated_journal(tmp_path, n_replicas=2, segment_records=4, primary="port",
                        replica="port", **sink_kw):
    Journal, compactor, Sink = PRIMARY[primary]
    replicas = [REPLICA[replica](str(tmp_path / f"replica{i}"), "127.0.0.1:0")
                for i in range(n_replicas)]
    targets = [r.start() for r in replicas]
    pdir = str(tmp_path / "primary")
    os.makedirs(pdir, exist_ok=True)
    j = Journal(pdir, segment_records=segment_records, compactor=compactor)
    sink = Sink(j, targets, node="A", **sink_kw)
    j.sink = sink
    sink.begin_epoch()
    return j, sink, replicas, targets, pdir


def _reborn(cls, replica, sink, k):
    """A replica reborn over its surviving directory on a fresh port, its
    sink link pointed at it and free to reconnect at once."""
    r = cls(replica.store.dir, "127.0.0.1:0")
    link = sink.links[k]
    link.target = r.start()
    link.retry_at = 0.0
    link.blackout_until = 0.0
    return r


# ---- byte-identical chains across the packages ---------------------------


@pytest.mark.parametrize("primary,replica", [("jax", "port"), ("port", "jax"),
                                             ("port", "port")])
def test_chains_are_byte_identical_across_the_packages(tmp_path, primary, replica):
    """Two rolls, a compaction and a resync from the BASE of a replica that
    was down through it: every replica ends byte-identical to the primary,
    whichever package wrote each side, and both packages' compare walks
    hold each pair clean frame for frame."""
    j, sink, replicas, targets, pdir = _replicated_journal(
        tmp_path, n_replicas=3, segment_records=3, primary=primary, replica=replica)
    for i in range(4):  # 1 + 8 records: rolls the active segment twice
        j.append(_accept_rec(i))
        j.append({"t": "state", "job_id": f"j{i}", "state": "DONE"})
    segs = [n for n in os.listdir(pdir) if n.startswith("journal-")]
    assert len(segs) >= 2 and sink.quorum_ok()
    want = _chain_bytes(pdir)
    for r in replicas:
        assert _chain_bytes(r.store.dir) == want
    replicas[0].die()
    time.sleep(0.05)
    j.append(_accept_rec(4))
    j.compact()  # the BASE: live followers resync from it, the dead one misses it
    j.append(_accept_rec(5))
    assert j.compactions == 1 and sink.quorum_ok()
    reborn = _reborn(REPLICA[replica], replicas[0], sink, 0)
    sink.heartbeat()  # behind the BASE: reset and resynced from it
    want = _chain_bytes(pdir)
    for d in [reborn.store.dir] + [r.store.dir for r in replicas[1:]]:
        assert _chain_bytes(d) == want
        a, b = run_compare(pdir, d), j_compare(pdir, d)
        assert a.clean and a.checked["frames_compared"] > 0
        assert [f.as_dict() for f in a.findings] == [f.as_dict() for f in b.findings]
        assert a.checked == b.checked
    assert sink.resyncs >= 3
    sink.close()
    j.close()


def test_pool_ledger_replicates_through_same_machinery(tmp_path):
    j, sink, replicas, _, pdir = _replicated_journal(tmp_path)
    j.append({"t": "unit", "unit_id": "u1", "spec": "s1"})
    j.append({"t": "lease", "unit_id": "u1", "worker": "w1", "epoch": 1})
    j.append({"t": "ack", "unit_id": "u1", "worker": "w1", "result": {"cycles": 42}})
    want = _chain_bytes(pdir)
    for r in replicas:
        assert _chain_bytes(r.store.dir) == want
    sink.close()
    j.close()


# ---- catch-up ------------------------------------------------------------


def test_follower_catches_up_across_two_rolls_chain_identical(tmp_path):
    j, sink, replicas, targets, pdir = _replicated_journal(tmp_path, n_replicas=3,
                                                           segment_records=3)
    j.append({"t": "accept", "job_id": "j0", "spec": {}})
    replicas[0].die()
    time.sleep(0.05)
    for i in range(1, 9):  # rolls the active segment at least twice
        j.append({"t": "accept", "job_id": f"j{i}", "spec": {}})
    assert sink.quorum_ok()  # quorum 2 of 3
    assert _chain_bytes(replicas[0].store.dir) != _chain_bytes(pdir)
    reborn = _reborn(ReplicaServer, replicas[0], sink, 0)
    sink.heartbeat()
    want = _chain_bytes(pdir)
    assert _chain_bytes(reborn.store.dir) == want
    for r in replicas[1:]:
        assert _chain_bytes(r.store.dir) == want
    assert sink.resyncs >= 1
    sink.close()
    j.close()


def test_recovered_replica_resyncs_once_per_append(tmp_path):
    j, sink, replicas, targets, pdir = _replicated_journal(tmp_path, n_replicas=3)
    replicas[0].die()
    time.sleep(0.05)
    link = sink.links[0]
    link._drop()  # the failure detector's verdict, made deterministic
    j.append({"t": "accept", "job_id": "j0", "spec": {}})  # missed by r0
    reborn = _reborn(ReplicaServer, replicas[0], sink, 0)
    before = sink.resyncs
    j.append({"t": "accept", "job_id": "j1", "spec": {}})
    assert sink.resyncs == before + 1  # exactly one sync, counted as ack
    assert sink.quorum_ok()
    assert _chain_bytes(reborn.store.dir) == _chain_bytes(pdir)
    sink.close()
    j.close()


# ---- the replication chaos sites ------------------------------------------


@pytest.mark.parametrize("site,action,args", [
    ("replicate.send", "partition", (("s", 0.2),)),
    ("replicate.send", "duplicate", ()),
    ("replicate.send", "delay", (("s", 0.01),)),
    ("replica.pre-fsync-ack", "kill", ()),
])
def test_replication_chaos_sites(tmp_path, site, action, args):
    """The port's `replicate.send` site partitions, duplicates or delays
    the primary's third order to the first replica, and its
    `replica.pre-fsync-ack` crashpoint kills a replica between its write
    and its fsync: the injected frame misses that replica (a partition or
    a death costs the 2-of-3 quorum nothing), the duplicate bounces off
    the position check, and after the replica is back every chain is
    byte-identical to the primary's."""
    from primesim_tpu_torch import chaos
    from primesim_tpu_torch.chaos import sites

    j, sink, replicas, targets, pdir = _replicated_journal(tmp_path, n_replicas=3)
    rt = sites.install(chaos.FaultPlan(seed=0, events=(
        chaos.FaultEvent(site, 3 if site == "replicate.send" else 4, action, args),)))
    try:
        for i in range(4):
            j.append({"t": "note", "msg": f"n{i}"})
            assert sink.quorum_ok(), i
    finally:
        sites.deactivate()
    assert [e["site"] for e in rt.injected] == [site]
    if action == "partition":
        time.sleep(0.25)  # the blackout ends
    if site == "replica.pre-fsync-ack":
        dead = next(r for r in replicas if r.dead)
        k = replicas.index(dead)
        replicas[k] = _reborn(ReplicaServer, dead, sink, k)
    for link in sink.links:
        link.retry_at = 0.0
    sink.heartbeat()
    want = _chain_bytes(pdir)
    for r in replicas:
        assert _chain_bytes(r.store.dir) == want
    sink.close()
    j.close()


# ---- quorum policies -----------------------------------------------------


def test_quorum_block_raises_replica_quorum_lost(tmp_path):
    pdir = str(tmp_path / "p")
    os.makedirs(pdir)
    j = JobJournal(pdir)
    sink = ReplicationSink(j, [str(tmp_path / "void0.sock"), str(tmp_path / "void1.sock")],
                           policy="block", retry_after_s=1.5)
    j.sink = sink
    sink.begin_epoch()
    assert not sink.quorum_ok()
    with pytest.raises(ReplicaQuorumLost) as ei:
        sink.check_admission()
    assert ei.value.retry_after_s == 1.5
    sink.close()
    j.close()


def test_quorum_degrade_acks_locally_and_counts(tmp_path):
    pdir = str(tmp_path / "p")
    os.makedirs(pdir)
    j = JobJournal(pdir)
    sink = ReplicationSink(j, [str(tmp_path / "void.sock")], policy="degrade")
    j.sink = sink
    sink.begin_epoch()
    j.append({"t": "accept", "job_id": "j1", "spec": {}})
    sink.check_admission()  # degrade: does NOT raise
    assert sink.degraded_acks >= 2 and sink.quorum_losses >= 2
    assert not sink.quorum_ok()
    st = sink.status()
    assert st["policy"] == "degrade" and not st["quorum_ok"]
    sink.close()
    j.close()


def test_quorum_default_and_validation_equal_the_jax_package(tmp_path):
    """Strict majority by default (N//2 + 1), 2K > N for any explicit K,
    1 <= K <= N, and a policy of block or degrade: the port accepts and
    refuses exactly what the JAX package does, with its messages."""
    pdir = str(tmp_path / "p")
    os.makedirs(pdir)
    j = JobJournal(pdir)
    for n, want in ((1, 1), (2, 2), (3, 2), (4, 3), (5, 3)):
        sink = ReplicationSink(j, [f"r{i}:1" for i in range(n)])
        assert sink.quorum == want == n // 2 + 1
        sink.close()
    for n, k, kw in ((2, 1, {}), (4, 2, {}), (5, 2, {}), (2, 3, {}), (3, 0, {"policy": "x"}),
                     (2, 2, {"policy": "eventual"})):
        targets = [f"r{i}:1" for i in range(n)]
        msgs = []
        for Sink in (ReplicationSink, JR.ReplicationSink):
            with pytest.raises((ReplicaQuorumLost, JR.ReplicaQuorumLost)) as ei:
                Sink(j, targets, quorum=k or None, **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    sb = Standby("nope.sock", ["a:1", "b:2"], str(tmp_path / "s"))
    assert sb.min_reachable == 2
    sb3 = Standby("nope.sock", ["a:1", "b:2", "c:3"], str(tmp_path / "s3"))
    assert sb3.min_reachable == 2
    j.close()


# ---- fencing / promotion -------------------------------------------------


def test_standby_promotion_fences_old_primary(tmp_path):
    j, a_sink, replicas, targets, pdir = _replicated_journal(tmp_path)
    for i in range(5):
        j.append({"t": "accept", "job_id": f"j{i}", "spec": {}})
    assert a_sink.epoch == 1
    b_dir = str(tmp_path / "standby")
    report = pull_chain(targets, b_dir)
    assert report["reachable"] == 2
    b_j = JobJournal(b_dir, compactor=serve_compactor)
    b_sink = ReplicationSink(b_j, targets, node="B")
    b_j.sink = b_sink
    assert b_sink.begin_epoch() == 2
    assert b_sink.quorum_ok()
    j.append({"t": "note", "msg": "doomed write from the old reign"})
    assert a_sink.fenced and not a_sink.quorum_ok()
    with pytest.raises(PrimaryFenced) as ei:
        a_sink.check_admission()
    assert ei.value.epoch == 2
    b_j.append({"t": "accept", "job_id": "b1", "spec": {}})
    want = _chain_bytes(b_dir)
    for r in replicas:
        assert _chain_bytes(r.store.dir) == want
        assert "doomed write" not in "".join(_chain_bytes(r.store.dir).values())
    for s_, jj in ((a_sink, j), (b_sink, b_j)):
        s_.close()
        jj.close()


def test_deposed_primary_divergent_tail_discarded_on_rejoin(tmp_path):
    j, a_sink, replicas, targets, pdir = _replicated_journal(tmp_path)
    j.append({"t": "accept", "job_id": "j0", "spec": {}})
    b_dir = str(tmp_path / "standby")
    pull_chain(targets, b_dir)
    b_j = JobJournal(b_dir, compactor=serve_compactor)
    b_sink = ReplicationSink(b_j, targets, node="B")
    b_j.sink = b_sink
    b_sink.begin_epoch()
    t = replicas[0].store.tip()
    replicas[0].store.apply_append(t["seq"], t["crc"], _frame({"t": "note", "msg": "orphan tail"}))
    b_j.append({"t": "accept", "job_id": "b1", "spec": {}})
    want = _chain_bytes(b_dir)
    for r in replicas:
        assert _chain_bytes(r.store.dir) == want
    assert "orphan tail" not in "".join(_chain_bytes(replicas[0].store.dir).values())
    for s_, jj in ((a_sink, j), (b_sink, b_j)):
        s_.close()
        jj.close()


def test_standby_requires_reachable_quorum_to_promote(tmp_path):
    j, a_sink, replicas, targets, pdir = _replicated_journal(tmp_path)
    j.append({"t": "accept", "job_id": "j0", "spec": {}})
    for r in replicas:
        r.shutdown()  # gone: their ports refuse connections
    sb = Standby("nope.sock", targets, str(tmp_path / "standby"), grace_s=0.0, min_reachable=1)
    with pytest.raises(ReplicaQuorumLost):
        sb.promote_pull()
    a_sink.close()
    j.close()


def test_pull_chain_prefers_newest_epoch_over_longer_stale_tail(tmp_path):
    """Reign 1 ships to r0 only; reign 2 (promoted off r0) ships to r1 only;
    the partitioned reign 1 then grows r0's chain longer than r1's. The
    promotion must adopt r1's (the newest epoch), in the port as in JAX:
    the JAX `pull_chain` run over the same replicas picks the same source
    and writes the same bytes."""
    r0 = ReplicaServer(str(tmp_path / "r0"), "127.0.0.1:0")
    t0 = r0.start()
    a_dir = str(tmp_path / "a")
    os.makedirs(a_dir)
    a_j = JobJournal(a_dir)
    a_sink = ReplicationSink(a_j, [t0], node="A")
    a_j.sink = a_sink
    a_sink.begin_epoch()
    a_j.append({"t": "accept", "job_id": "j0", "spec": {}})
    r1 = ReplicaServer(str(tmp_path / "r1"), "127.0.0.1:0")
    t1 = r1.start()
    b_dir = str(tmp_path / "b")
    pull_chain([t0], b_dir)
    b_j = JobJournal(b_dir)
    b_sink = ReplicationSink(b_j, [t1], node="B")
    b_j.sink = b_sink
    assert b_sink.begin_epoch() == 2
    b_j.append({"t": "accept", "job_id": "acked-by-reign-2", "spec": {}})
    assert b_sink.quorum_ok()
    for i in range(8):
        a_j.append({"t": "accept", "job_id": f"stale{i}", "spec": {}})
    assert r0.store.tip()["records"] > r1.store.tip()["records"]
    report = pull_chain([t0, t1], str(tmp_path / "c"))
    j_report = JR.pull_chain([t0, t1], str(tmp_path / "jc"))
    assert report["source"] == j_report["source"] == t1
    assert report["tip"] == j_report["tip"]
    adopted = _chain_bytes(str(tmp_path / "c"))
    assert adopted == _chain_bytes(str(tmp_path / "jc"))
    assert "acked-by-reign-2" in "".join(adopted.values())
    for s_, jj in ((a_sink, a_j), (b_sink, b_j)):
        s_.close()
        jj.close()


def test_compaction_preserves_fencing_epoch(tmp_path):
    from primesim_tpu_torch.serve.journal import fold_records

    j, sink, replicas, targets, pdir = _replicated_journal(tmp_path)
    for i in range(6):
        j.append(_accept_rec(i))
        j.append({"t": "state", "job_id": f"j{i}", "state": "DONE"})
    assert sink.epoch == 1
    j.compact()
    records, _ = j.replay()
    assert max_epoch(records) == 1
    jobs, _clean = fold_records(records)
    assert len(jobs) == 6
    reborn = ReplicaServer(replicas[0].store.dir, "127.0.0.1:0")
    assert reborn.epoch == 1
    assert reborn.handle({"verb": "repl.hello", "epoch": 0})["fenced"]
    sink.close()
    j.close()


def test_diverged_rolled_prefix_forces_full_resync(tmp_path):
    stale_dir = str(tmp_path / "stale")
    os.makedirs(stale_dir)
    stale = JobJournal(stale_dir, segment_records=3)
    for i in range(7):
        stale.append({"t": "accept", "job_id": f"stale{i}", "spec": {}})
    stale.close()
    r_dir = str(tmp_path / "replica")
    shutil.copytree(stale_dir, r_dir)
    rep = ReplicaServer(r_dir, "127.0.0.1:0")
    target = rep.start()
    pdir = str(tmp_path / "primary")
    os.makedirs(pdir)
    j = JobJournal(pdir, segment_records=3)
    j.append({"t": "epoch", "epoch": 2, "node": "B"})
    for i in range(6):
        j.append({"t": "accept", "job_id": f"new{i}", "spec": {}})
    sink = ReplicationSink(j, [target], node="B")
    j.sink = sink
    sink.epoch = 2
    sink.heartbeat()
    assert sink.quorum_ok()
    got = _chain_bytes(rep.store.dir)
    assert got == _chain_bytes(pdir)
    assert "stale" not in "".join(got.values())
    assert run_compare(pdir, r_dir).clean
    sink.close()
    j.close()


# ---- fsck --compare ------------------------------------------------------


def test_fsck_compare_prefix_clean_divergence_corrupt(tmp_path):
    """One durable frame behind is a clean prefix; a validly framed frame
    of another history is corrupt. The port's findings and counts equal
    the JAX package's on both pairs."""
    j, sink, replicas, targets, pdir = _replicated_journal(tmp_path)
    for i in range(6):
        j.append({"t": "accept", "job_id": f"j{i}", "spec": {}})
    replicas[0].die()
    time.sleep(0.05)
    j.append({"t": "accept", "job_id": "late", "spec": {}})
    sink.close()
    j.close()
    bad = str(tmp_path / "bad")
    shutil.copytree(pdir, bad)
    p = os.path.join(bad, "journal.jsonl")
    lines = _scan_lines(p)
    rec = _unframe(lines[-1])
    rec["job_id"] = "evil"
    lines[-1] = _frame(rec)
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    for other, clean in ((replicas[0].store.dir, True), (bad, False)):
        a, b = run_compare(pdir, other), j_compare(pdir, other)
        assert a.clean == b.clean == clean
        assert [f.as_dict() for f in a.findings] == [f.as_dict() for f in b.findings]
        assert a.checked == b.checked and a.checked["frames_compared"] > 0
    assert any("diverges" in f.detail for f in run_compare(pdir, bad).corrupt)


def test_fsck_compare_cli_exits_equal_primetpu(tmp_path, capsys):
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    j, sink, replicas, targets, pdir = _replicated_journal(tmp_path)
    j.append({"t": "accept", "job_id": "j0", "spec": {}})
    sink.close()
    j.close()
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    bj = JobJournal(bad)
    bj.append({"t": "accept", "job_id": "other-history", "spec": {}})
    bj.close()
    outs = []
    for fn in (jax_main, main):
        rc0 = fn(["fsck", "--compare", pdir, replicas[0].store.dir])
        out0 = capsys.readouterr().out
        rc2 = fn(["fsck", "--compare", pdir, bad, "--format", "json"])
        cap = capsys.readouterr()
        outs.append((rc0, out0, rc2, cap.out, json.loads(cap.err.splitlines()[-1])))
    assert outs[0] == outs[1]
    assert outs[1][0] == 0 and outs[1][2] == 2
    assert outs[1][4]["error"]["type"] == "FsckCorrupt"


# ---- the daemon with replicas, in a thread --------------------------------


def _cfg():
    return port_cfg(small_test_config(4))


def _daemon(tmp_path, name, targets, **kw):
    from primesim_tpu_torch.serve.server import PrimeServer

    server = PrimeServer(_cfg(), state_dir=str(tmp_path / name), buckets=((2, 1),),
                         chunk_steps=CHUNK, device="cpu", replicas=targets, node=name, **kw)
    box = {}
    t = threading.Thread(target=lambda: box.update(rc=server.serve_forever()), daemon=True)
    t.start()
    deadline = time.time() + DEADLINE_S
    while not os.path.exists(server.socket_path):
        assert time.time() < deadline and t.is_alive()
        time.sleep(0.01)
    return server, t, box


def test_daemon_gates_admission_on_quorum_and_self_fences(tmp_path):
    """No replica reachable: under block a submit is refused with typed
    backpressure and leaves no job; under degrade it is ACKed and health
    flags it. With live replicas the daemon ACKs, reports `replication`
    in its health and metrics, and once a standby opens epoch 2 on the
    same replicas its heartbeat meets the fence: it exits 75."""
    from primesim_tpu_torch.serve.client import ServeClient, ServeError

    void = [str(tmp_path / "void0.sock"), str(tmp_path / "void1.sock")]
    for policy in ("block", "degrade"):
        server, t, box = _daemon(tmp_path, f"srv-{policy}", void, quorum_policy=policy)
        cli = ServeClient(server.socket_path, timeout_s=30.0)
        if policy == "block":
            with pytest.raises(ServeError) as ei:
                cli.submit(synth=SMALL_SYNTH.format(1), client="c")
            assert ei.value.reply["error"]["type"] == "ReplicaQuorumLost"
            assert ei.value.reply["retry_after_s"] == 2.0
            assert server.sched.jobs == {}
        else:
            assert cli.submit(synth=SMALL_SYNTH.format(1), client="c")["job_id"] == "j000001"
            h = cli.health()["replication"]
            assert h["policy"] == "degrade" and not h["quorum_ok"] and h["degraded_acks"] >= 1
        server._draining = server._stop = True
        t.join(timeout=DEADLINE_S)

    replicas = [ReplicaServer(str(tmp_path / f"r{i}"), "127.0.0.1:0") for i in range(2)]
    targets = [r.start() for r in replicas]
    server, t, box = _daemon(tmp_path, "primary", targets)
    cli = ServeClient(server.socket_path, timeout_s=30.0)
    job = cli.submit(synth=SMALL_SYNTH.format(2), client="c")
    assert cli.wait(job["job_id"], timeout_s=DEADLINE_S)["state"] == "DONE"
    h = cli.health()["replication"]
    assert (h["epoch"], h["quorum"], h["quorum_ok"], h["fenced"]) == (1, 2, True, False)
    assert "primetpu_replication_epoch 1" in cli.metrics()
    b_dir = str(tmp_path / "standby")
    pull_chain(targets, b_dir)
    b_j = JobJournal(b_dir, compactor=serve_compactor)
    b_sink = ReplicationSink(b_j, targets, node="B")
    b_j.sink = b_sink
    assert b_sink.begin_epoch() == 2
    t.join(timeout=DEADLINE_S)
    assert box["rc"] == 75
    records, _ = server.journal.replay()
    assert any(r.get("t") == "note" and "fenced by epoch 2" in r.get("msg", "")
               for r in records)
    b_sink.close()
    b_j.close()


# ---- the failover story, through the CLI ----------------------------------


@functools.lru_cache(maxsize=None)
def jax_fleet_results(specs):
    """One JAX FleetEngine run of the served workloads: per element the
    per-core cycles and every counter a served job is held to."""
    from primesim_tpu.serve.scheduler import parse_synth_spec
    from primesim_tpu.sim.fleet import FleetEngine

    cfg = small_test_config(4)
    fleet = FleetEngine(cfg, [parse_synth_spec(s, cfg.n_cores, True) for s in specs],
                        [{} for _ in specs], chunk_steps=CHUNK)
    fleet.run()
    out = []
    for i in range(len(specs)):
        ec = fleet.element_counters(i)
        out.append(([int(c) for c in fleet.cycles[i]],
                    {k: [int(x) for x in v] for k, v in ec.items()}))
    return out


def _spawn(argv, ready_prefix):
    """`python -m primesim_tpu_torch ARGV`; returns (process, its readiness
    line) once stderr shows `ready_prefix`."""
    proc = subprocess.Popen([sys.executable, "-m", "primesim_tpu_torch", *argv], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + DEADLINE_S
    while True:
        if proc.poll() is not None:
            raise AssertionError("process died before readiness: "
                                 + proc.stderr.read().decode()[-2000:])
        line = proc.stderr.readline().decode()
        if ready_prefix in line:
            return proc, line.strip()
        assert time.time() < deadline, f"no {ready_prefix!r} line"


def _target(line):
    return line.split("listening on ", 1)[1].split(" ", 1)[0]


def test_cli_failover_after_the_primary_loses_its_disk(tmp_path):
    """kill -9 the primary AND delete its state directory after its jobs
    were ACKed: the standby promotes off the replicas at epoch 2, every
    job reaches DONE equal to the JAX fleet run, the standby exits 0 once
    idle, and `fsck --compare` holds its chain to each replica's (and
    `fsck` of its state directory is clean) — the port's CLI and
    `primetpu`'s alike."""
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main
    from primesim_tpu_torch.serve.client import ServeClient

    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(_cfg().to_json())
    r_dirs = [str(tmp_path / f"replica{i}") for i in range(2)]
    serve = ["--buckets", "2x1,1x4", "--chunk-steps", str(CHUNK), "--device", "cpu"]
    procs = []
    try:
        for d in r_dirs:
            procs.append(_spawn(["replica", "--dir", d, "--tcp", "127.0.0.1:0"],
                                "replica: listening on"))
        replicas = ",".join(_target(ln) for _, ln in procs)
        a_dir = str(tmp_path / "primary-a")
        pa, line = _spawn(["serve", cfg_path, "--state-dir", a_dir, "--tcp", "127.0.0.1:0",
                           "--replicas", replicas, *serve], "serve: listening on")
        procs.append((pa, line))
        assert "replicated x2 quorum=2 epoch=1" in line
        b_dir = str(tmp_path / "standby-b")
        pb, _ = _spawn(["serve", cfg_path, "--state-dir", b_dir, "--tcp", "127.0.0.1:0",
                        "--replicas", replicas, "--standby-of", _target(line),
                        "--takeover-grace", "1.0", "--idle-exit", "3.0", *serve],
                       "serve: standby of")
        procs.append((pb, ""))
        specs = (SMALL_SYNTH.format(31), SMALL_SYNTH.format(32), LONG_SYNTH.format(33))
        cli = ServeClient(_target(line), timeout_s=60.0)
        ids = [cli.submit(synth=s, client="c")["job_id"] for s in specs]
        pa.send_signal(signal.SIGKILL)
        pa.wait(timeout=DEADLINE_S)
        shutil.rmtree(a_dir)
        deadline, b_line = time.time() + DEADLINE_S, None
        while b_line is None:
            assert time.time() < deadline, "the standby never promoted"
            ln = pb.stderr.readline().decode()
            if "serve: listening on" in ln:
                b_line = ln
        assert "replicated x2 quorum=2 epoch=2" in b_line
        cli2 = ServeClient(_target(b_line), timeout_s=60.0)
        results = [cli2.wait(i, timeout_s=DEADLINE_S) for i in ids]
        pb.communicate(timeout=DEADLINE_S)
        assert pb.returncode == 0
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=DEADLINE_S)
    for r, (cyc, ctr) in zip(results, jax_fleet_results(specs)):
        assert r["state"] == "DONE", r
        assert r["result"]["core_cycles"] == cyc
        assert r["result"]["counters"] == ctr
    for fn in (main, jax_main):
        for d in r_dirs:
            assert fn(["fsck", "--compare", b_dir, d]) == 0
        assert fn(["fsck", b_dir]) == 0
