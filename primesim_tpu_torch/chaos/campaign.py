"""Invariant-checked crash campaigns over the serve/pool stack: the JAX
package's `chaos/campaign.py` for the port.

A TRIAL runs a real serving workload under one seeded `FaultPlan` and
then machine-checks the durability story the stack promises:

  A. NO ACKED JOB LOST — every submit whose ACK was observed is present
     (same job_id, exactly once) after every crash/restart, and reaches
     a terminal state.
  B. BIT-EXACT RESULTS — surviving state replays to the same results a
     fault-free GOLDEN run of the identical workload produces
     (deterministic fields only; wall-clock throughput is stripped).
  C. FSCK CLEAN — `fsck` over the surviving state directory
     finds nothing corrupt (a torn tail in the newest journal segment is
     legal by the WAL contract and repaired on open, so it never shows).
  D. NO DOUBLE-ENQUEUE — a retried submit after a lost ACK (idempotency
     token) must not create a twin job.

The serve trial is IN-PROCESS: it rebuilds the scheduler over the same
state dir after every injected crash, exactly replicating the server's
`_recover()` (journal replay -> fold -> adopt/requeue). Injected process
death arrives as `ChaosCrash` (BaseException) and the harness plays the
role of init: catch, count the restart, boot again. One ChaosRuntime
spans the whole trial, so fired events never re-fire and a plan with K
crash events bounds the trial at K restarts.

The socket trial runs a REAL PrimeServer in a thread and drives it with
a `ServeClient` whose reconnect/idempotency machinery is the system
under test; its plans draw only from the client-side socket sites.

On violation, `run_campaign` shrinks the plan (greedy ddmin re-running
the trial) to a 1-minimal event set and writes a repro artifact: the
seed, the shrunk plan JSON, and the violation text — `python -m
primesim_tpu_torch chaos --plan <artifact>` replays it (and so does
`primetpu chaos --plan`: plans, sites and artifacts are the JAX
package's).

Every harness simulates on one device, `cuda` unless the caller passes
`device` (the tests pass "cpu"): the schedulers, the server, the pool's
worker threads and the capacity trial's engine all run there, and with
no card and no device named every entry point raises before it starts.
The capacity trial's supervised engine is sharded, as the JAX trial's
is, when the device's platform shows more than one visible device (the
CPU's `XLA_FLAGS` count, or ids declared with
`parallel.sharding.virtual_devices`): on `largest_valid_submesh` of
them, so a `devices.revoke` event reshards it onto a smaller mesh. With
one visible device it runs unsharded and a revocation takes nothing.
Either way its result is held to the fault-free unsharded reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np

from ..sim.engine import resolve_device
from . import plan as P
from . import sites

#: Sites the in-process serve trial actually reaches, by fault class.
SERVE_SITES = {
    "durable": ("journal.append", "checkpoint.write"),
    "crashpoint": (
        "server.post-journal-pre-ack",
        "scheduler.pre-dispatch",
        "scheduler.post-dispatch",
        "scheduler.post-checkpoint",
    ),
    "socket": ("protocol.send", "protocol.recv"),
}

#: Sites only the replication trial reaches. Opt-in via `--classes
#: replication` — they are NOT folded into the default campaign, so
#: plain durable/crashpoint runs keep their historical trial shape.
#: `replica.pre-fsync-ack` is crashpoint-CLASS (its only action is
#: kill) but replication-trial-ONLY, so listing "replication" pulls it
#: in: a replication campaign without replica deaths would never
#: exercise catch-up or promotion-under-loss.
REPLICATION_SITES = ("replicate.send", "replica.pre-fsync-ack")

#: Silent-data-corruption sites: the attestation trial (DESIGN.md §24).
#: Opt-in via `--classes silent_corruption` and routed to their OWN
#: trial — a flip in a serve-trial fleet would be undetectable by
#: construction (that is the whole point of attestation) and would read
#: as a bogus invariant-B violation there.
ATTEST_SITES = ("fleet.counters", "checkpoint.payload")

#: Degraded-mode capacity sites (DESIGN.md §26). Opt-in via `--classes
#: capacity_loss` and routed to their OWN trial: seeded device
#: revocation needs a supervised engine (the serve trial's fleets have
#: no supervisor), and sustained-ENOSPC windows need a
#: harness that plays a backpressured client — retrying on
#: `DiskPressureError` — rather than reading the typed rejection as a
#: crash. The trial machine-checks INVARIANT G: no ACKed job lost and
#: no bit-exactness violation under capacity loss.
CAPACITY_SITES = ("devices.revoke", "disk.preflight")

#: Small deterministic workloads (serve's synth grammar). Distinct seeds
#: give distinct results, so a cross-wired job table fails invariant B.
DEFAULT_SPECS = (
    "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed=101",
    "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed=102",
    "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed=103",
)

_MAX_TICKS = 20_000  # convergence guard for one boot's tick loop

# result fields that depend on wall time, not on the simulation
_NONDET_KEYS = ("wall_s", "value", "latency_s", "accepted_t")


@dataclasses.dataclass
class TrialResult:
    plan: P.FaultPlan
    violations: list
    injected: list        # events that actually fired, in order
    restarts: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "seed": self.plan.seed,
            "plan": self.plan.as_dict(),
            "violations": list(self.violations),
            "injected": list(self.injected),
            "restarts": self.restarts,
        }


def _canon(result) -> str:
    """Canonical form of a job result for bit-exact comparison: drop
    wall-clock-dependent fields, keep every simulation-determined one."""

    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in sorted(obj.items())
                    if k not in _NONDET_KEYS}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    return json.dumps(strip(result), sort_keys=True)


def _default_cfg():
    from ..config.machine import small_test_config

    return small_test_config(4)


# ---- the in-process serve trial ------------------------------------------


def _boot(state_dir: str, cfg, buckets, chunk_steps: int, device):
    """One server lifetime's worth of scheduler, recovered from whatever
    the previous lifetime left on disk — the exact `server._recover()`
    sequence, minus the listener."""
    from ..serve.journal import JobJournal, fold_records, serve_compactor
    from ..serve.scheduler import Scheduler

    journal = JobJournal(state_dir, compactor=serve_compactor)
    sched = Scheduler(
        cfg, journal, state_dir, buckets=buckets, chunk_steps=chunk_steps,
        checkpoint_every_s=0.0,  # checkpoint every tick: deterministic,
        #                          and it exercises checkpoint.write hard
        device=device,
    )
    records, _dropped = journal.replay()
    jobs, _clean = fold_records(records)
    for job in jobs.values():
        if job.terminal:
            sched.adopt_terminal(job)
        else:
            sched.requeue_recovered(job)
    if jobs:
        sched._seq = max(
            (int(j.job_id[1:]) for j in jobs.values()
             if j.job_id.startswith("j") and j.job_id[1:].isdigit()),
            default=0,
        )
    return sched


def _submit_missing(sched, specs, idems, acked, violations) -> None:
    """Replicate the client's retried-submit path: anything not yet
    ACKed is (re)submitted under its idempotency token; a token already
    in the job table means the previous attempt's accept record survived
    a lost ACK and the job is adopted instead of double-enqueued."""
    from ..serve import jobs as J

    for i in range(len(specs)):
        jid = acked.get(i)
        if jid is not None:
            if jid not in sched.jobs:
                violations.append(
                    f"invariant A: ACKed job {jid} (spec {i}) lost after "
                    "restart"
                )
            continue
        dup = next(
            (j for j in sched.jobs.values() if j.idem == idems[i]), None
        )
        if dup is not None:
            acked[i] = dup.job_id  # lost-ACK retry answered by dedup
            continue
        job = J.Job(job_id=sched.next_job_id(), idem=idems[i],
                    client="chaos", synth=specs[i])
        sched.submit(job)  # may ChaosCrash post-journal-pre-ack: no ACK
        acked[i] = job.job_id  # returned = ACK observed


def _check_no_twins(sched, idems, violations) -> None:
    per_tok = {}
    for j in sched.jobs.values():
        if j.idem:
            per_tok[j.idem] = per_tok.get(j.idem, 0) + 1
    for tok, n in sorted(per_tok.items()):
        if tok in set(idems.values()) and n > 1:
            violations.append(
                f"invariant D: idempotency token {tok} enqueued {n} jobs"
            )


def _run_to_completion(state_dir, cfg, specs, idems, acked, violations,
                       buckets, chunk_steps, device) -> dict:
    """One boot: recover, check invariant A, (re)submit what is missing,
    tick until every ACKed job is terminal. Raises ChaosCrash whenever
    the plan kills this 'process'; the caller restarts us."""
    sched = _boot(state_dir, cfg, buckets, chunk_steps, device)
    _submit_missing(sched, specs, idems, acked, violations)
    _check_no_twins(sched, idems, violations)
    for _ in range(_MAX_TICKS):
        if all(sched.jobs[j].terminal for j in acked.values()
               if j in sched.jobs):
            break
        sched.tick()
    else:
        violations.append(
            f"trial did not converge within {_MAX_TICKS} ticks"
        )
    out = {}
    for i, jid in acked.items():
        job = sched.jobs.get(jid)
        if job is None:
            continue  # invariant A already recorded the loss
        out[i] = {"state": job.state, "result": job.result}
    sched.journal.close()
    return out


def run_serve_trial(
    plan: P.FaultPlan,
    cfg=None,
    specs=DEFAULT_SPECS,
    golden: dict | None = None,
    workdir: str | None = None,
    keep_dir: bool = False,
    buckets=((2, 1),),
    chunk_steps: int = 16,
    device=None,
) -> TrialResult:
    """One seeded trial of the in-process serve stack (see module doc).
    `golden` is the fault-free reference from `golden_run` (computed
    here when omitted — pass it when running many trials)."""
    from ..analysis.fsck import run_fsck

    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    if golden is None:
        golden = golden_run(cfg, specs, buckets=buckets,
                            chunk_steps=chunk_steps, workdir=workdir,
                            device=device)
    tmp = tempfile.mkdtemp(prefix="chaos-trial-", dir=workdir)
    violations: list = []
    acked: dict = {}
    idems = {i: f"chaos-{plan.seed}-{i}" for i in range(len(specs))}
    restarts = 0
    results: dict = {}
    rt = sites.install(plan, mode="raise")
    try:
        while True:
            try:
                results = _run_to_completion(
                    tmp, cfg, specs, idems, acked, violations,
                    buckets, chunk_steps, device,
                )
                break
            except sites.ChaosCrash:
                restarts += 1
                if restarts > len(plan.events) + 2:
                    # cannot happen while events fire at most once; a
                    # busted runtime must not hang the campaign
                    violations.append(
                        f"restart loop: {restarts} restarts for "
                        f"{len(plan.events)} planned events"
                    )
                    break
        injected = list(rt.injected)
    finally:
        sites.deactivate()

    rep = run_fsck(tmp)
    for f in rep.corrupt:
        violations.append(
            f"invariant C: fsck {f.kind} at {f.path}: {f.detail}"
        )
    for i in sorted(golden):
        got = results.get(i)
        if got is None:
            if f"invariant A" not in " ".join(violations):
                violations.append(
                    f"invariant A: spec {i} never reached a terminal "
                    "state"
                )
            continue
        if _canon(got) != _canon(golden[i]):
            violations.append(
                f"invariant B: spec {i} result diverged from golden "
                f"(got {_canon(got)[:200]}... want "
                f"{_canon(golden[i])[:200]}...)"
            )
    if not keep_dir:
        shutil.rmtree(tmp, ignore_errors=True)
    return TrialResult(plan=plan, violations=violations,
                       injected=injected, restarts=restarts)


def golden_run(cfg=None, specs=DEFAULT_SPECS, buckets=((2, 1),),
               chunk_steps: int = 16, workdir: str | None = None,
               device=None) -> dict:
    """The fault-free reference: run the identical workload with no plan
    installed and keep each job's terminal state + result."""
    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    tmp = tempfile.mkdtemp(prefix="chaos-golden-", dir=workdir)
    violations: list = []
    acked: dict = {}
    idems = {i: f"golden-{i}" for i in range(len(specs))}
    assert sites.runtime() is None, "golden run must be fault-free"
    try:
        out = _run_to_completion(tmp, cfg, specs, idems, acked,
                                 violations, buckets, chunk_steps, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if violations or set(out) != set(range(len(specs))):
        raise RuntimeError(f"golden run unhealthy: {violations or out}")
    for i, rec in out.items():
        if rec["state"] != "DONE":
            raise RuntimeError(
                f"golden run: spec {i} ended {rec['state']}, want DONE"
            )
    return out


# ---- the socket trial (real server + resilient client) -------------------


def run_socket_trial(
    plan: P.FaultPlan,
    cfg=None,
    specs=DEFAULT_SPECS,
    golden: dict | None = None,
    workdir: str | None = None,
    buckets=((2, 1),),
    chunk_steps: int = 16,
    device=None,
) -> TrialResult:
    """One seeded trial of the wire path: a real PrimeServer thread, a
    ServeClient whose reconnect + idempotency machinery is under test,
    and a plan drawn from the client-side socket sites only (short send,
    mid-frame disconnect, lost reply, duplicate delivery, delay)."""
    import threading
    import time as _time

    from ..analysis.fsck import run_fsck
    from ..serve.client import ServeClient
    from ..serve.server import PrimeServer

    for ev in plan.events:
        if sites.SITES.get(ev.site) != "socket":
            raise ValueError(
                f"socket trial plans must be socket-class only, got "
                f"{ev.site}"
            )
    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    if golden is None:
        golden = golden_run(cfg, specs, buckets=buckets,
                            chunk_steps=chunk_steps, workdir=workdir,
                            device=device)
    tmp = tempfile.mkdtemp(prefix="chaos-sock-", dir=workdir)
    violations: list = []
    server = PrimeServer(cfg, state_dir=tmp, buckets=buckets,
                         chunk_steps=chunk_steps, checkpoint_every_s=60.0,
                         device=device)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    deadline = _time.time() + 60
    while not os.path.exists(server.socket_path):
        if _time.time() > deadline:
            raise RuntimeError("server socket never appeared")
        _time.sleep(0.01)

    rt = sites.install(plan, mode="raise")
    try:
        cli = ServeClient(server.socket_path, timeout_s=60.0,
                          max_reconnects=2 * len(plan.events) + 2)
        results: dict = {}
        for i, spec in enumerate(specs):
            job = cli.submit(synth=spec, client="chaos",
                             idem=f"chaos-{plan.seed}-{i}")
            done = cli.wait(job["job_id"], timeout_s=120.0)
            results[i] = {"state": done["state"],
                          "result": done.get("result")}
        listed = cli.status()
        injected = list(rt.injected)
    finally:
        sites.deactivate()
    try:
        ServeClient(server.socket_path, timeout_s=30.0).drain()
        t.join(timeout=60)
    except Exception:
        pass

    if len(listed) != len(specs):
        violations.append(
            f"invariant D: {len(listed)} jobs in table for "
            f"{len(specs)} submits (duplicate enqueue or loss)"
        )
    for i in sorted(golden):
        got = results.get(i)
        if got is None or _canon(got) != _canon(golden[i]):
            violations.append(
                f"invariant B: spec {i} diverged over the wire"
            )
    rep = run_fsck(tmp)
    for f in rep.corrupt:
        violations.append(
            f"invariant C: fsck {f.kind} at {f.path}: {f.detail}"
        )
    shutil.rmtree(tmp, ignore_errors=True)
    return TrialResult(plan=plan, violations=violations,
                       injected=injected)


# ---- the replication trial (primary + replicas + fenced failover) --------

_REIGN1_TICKS = 40  # primary A's tick budget before the injected host loss


def _boot_replicated(state_dir, cfg, buckets, chunk_steps, targets, node,
                     device):
    """`_boot` plus the replication sink: journal -> sink -> NEW FENCING
    EPOCH -> recover — the exact order the real server uses, so the
    epoch frame is the first record of every reign."""
    from ..serve.journal import JobJournal, fold_records, serve_compactor
    from ..serve.replicate import ReplicationSink
    from ..serve.scheduler import Scheduler

    journal = JobJournal(state_dir, compactor=serve_compactor)
    sink = ReplicationSink(journal, list(targets), policy="block",
                           node=node)
    journal.sink = sink
    sink.begin_epoch()
    sched = Scheduler(
        cfg, journal, state_dir, buckets=buckets, chunk_steps=chunk_steps,
        checkpoint_every_s=0.0, device=device,
    )
    records, _dropped = journal.replay()
    jobs, _clean = fold_records(records)
    for job in jobs.values():
        if job.terminal:
            sched.adopt_terminal(job)
        else:
            sched.requeue_recovered(job)
    if jobs:
        sched._seq = max(
            (int(j.job_id[1:]) for j in jobs.values()
             if j.job_id.startswith("j") and j.job_id[1:].isdigit()),
            default=0,
        )
    return sched, sink


def _submit_quorum(sched, sink, specs, idems, acked, violations) -> None:
    """`_submit_missing`, quorum-aware: a submit only counts as ACKed
    when its frames reached the replica quorum — exactly what the real
    server promises the client. A below-quorum submit stays un-ACKed
    and is retried (same idempotency token) once quorum returns; the
    fold-side dedup turning that retry into an adoption is invariant D's
    business."""
    from ..serve import jobs as J

    for i in range(len(specs)):
        jid = acked.get(i)
        if jid is not None:
            if jid not in sched.jobs:
                violations.append(
                    f"invariant A: ACKed job {jid} (spec {i}) lost after "
                    "failover"
                )
            continue
        dup = next(
            (j for j in sched.jobs.values() if j.idem == idems[i]), None
        )
        if dup is not None:
            acked[i] = dup.job_id  # lost-ACK retry answered by dedup
            continue
        if not sink.quorum_ok():
            continue  # admission blocked: correctly NOT ACKed
        job = J.Job(job_id=sched.next_job_id(), idem=idems[i],
                    client="chaos", synth=specs[i])
        sched.submit(job)
        if sink.quorum_ok():
            acked[i] = job.job_id  # quorum ACK observed by the client


def _reborn(replicas, targets) -> None:
    """Restart every chaos-killed replica over its SURVIVING directory
    (the disk outlives the process) on a fresh port — the operator
    action that restores quorum. In-place list mutation so the caller's
    next sink sees the new targets."""
    from ..serve.replicate import ReplicaServer

    for i, rep in enumerate(replicas):
        if not rep.dead:
            continue
        try:
            rep._srv.server_close()
        except (OSError, AttributeError):
            pass
        fresh = ReplicaServer(rep.store.dir, "127.0.0.1:0")
        replicas[i] = fresh
        targets[i] = fresh.start()


def run_replication_trial(
    plan: P.FaultPlan,
    cfg=None,
    specs=DEFAULT_SPECS,
    golden: dict | None = None,
    workdir: str | None = None,
    keep_dir: bool = False,
    buckets=((2, 1),),
    chunk_steps: int = 16,
    device=None,
) -> TrialResult:
    """One seeded trial of the replicated-journal story (DESIGN.md §21):

    1. primary A (quorum-blocking sink over two in-process replicas)
       submits the workload and ticks under the plan's partitions,
       delivery duplicates, link delays and replica kills;
    2. A's HOST is lost mid-flight (we stop driving it but keep its
       sink alive for the dual-primary probe); dead replicas are
       rebooted over their surviving disks;
    3. standby B promotes: pulls the highest-epoch replica chain, opens a
       higher fencing epoch, re-admits anything never ACKed, finishes
       every job;
    4. the deposed A then attempts a quorum round — if it can still
       ACK, that is INVARIANT E (dual primary) and the trial fails;
    5. checks: A (no quorum-ACKed job lost across the failover),
       B (bit-exact vs golden), C (fsck clean over B's dir),
       D (no idempotency twins), E (above), plus `fsck --compare` of
       B's chain against each surviving replica chain.
    """
    from ..analysis.fsck import run_compare, run_fsck
    from ..serve.replicate import ReplicaServer

    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    if golden is None:
        golden = golden_run(cfg, specs, buckets=buckets,
                            chunk_steps=chunk_steps, workdir=workdir,
                            device=device)
    root = tempfile.mkdtemp(prefix="chaos-repl-", dir=workdir)
    a_dir = os.path.join(root, "primary-a")
    b_dir = os.path.join(root, "standby-b")
    r_dirs = [os.path.join(root, f"replica{i}") for i in range(2)]
    os.makedirs(a_dir)
    replicas = [ReplicaServer(d, "127.0.0.1:0") for d in r_dirs]
    targets = [r.start() for r in replicas]

    violations: list = []
    acked: dict = {}
    idems = {i: f"chaos-{plan.seed}-{i}" for i in range(len(specs))}
    restarts = 0
    results: dict = {}
    a_journal = None
    a_sink = None
    rt = sites.install(plan, mode="raise")
    try:
        # -- reign 1: primary A under faults, killed mid-flight ----------
        while True:
            try:
                sched, a_sink = _boot_replicated(
                    a_dir, cfg, buckets, chunk_steps, targets, "A", device
                )
                a_journal = sched.journal
                _submit_quorum(sched, a_sink, specs, idems, acked,
                               violations)
                _check_no_twins(sched, idems, violations)
                for _ in range(_REIGN1_TICKS):
                    if acked and all(
                        sched.jobs[j].terminal for j in acked.values()
                        if j in sched.jobs
                    ) and len(acked) == len(specs):
                        break
                    sched.tick()
                    if len(acked) < len(specs) and a_sink.quorum_ok():
                        _submit_quorum(sched, a_sink, specs, idems,
                                       acked, violations)
                break
            except sites.ChaosCrash:
                restarts += 1
                if restarts > len(plan.events) + 2:
                    violations.append(
                        f"restart loop: {restarts} restarts for "
                        f"{len(plan.events)} planned events"
                    )
                    break

        # -- the host loss + operator recovery ---------------------------
        # A is no longer driven (its journal/sink stay live only so the
        # deposed-primary probe below can attempt a doomed quorum
        # round). Dead replicas reboot over their surviving disks FIRST:
        # promotion must see every chain any quorum ever wrote to.
        _reborn(replicas, targets)

        # -- reign 2: standby B promotes and finishes ---------------------
        for _attempt in range(len(plan.events) + 3):
            _reborn(replicas, targets)
            try:
                from ..serve.replicate import pull_chain

                pulled = pull_chain(targets, b_dir)
                if pulled["reachable"] < len(targets):
                    continue  # a replica is still down; "reboot" again
                b_sched, b_sink = _boot_replicated(
                    b_dir, cfg, buckets, chunk_steps, targets, "B", device
                )
                _submit_quorum(b_sched, b_sink, specs, idems, acked,
                               violations)
                _check_no_twins(b_sched, idems, violations)
                for _ in range(_MAX_TICKS):
                    if len(acked) == len(specs) and all(
                        b_sched.jobs[j].terminal
                        for j in acked.values() if j in b_sched.jobs
                    ):
                        break
                    b_sched.tick()
                    if len(acked) < len(specs) and b_sink.quorum_ok():
                        _submit_quorum(b_sched, b_sink, specs, idems,
                                       acked, violations)
            except sites.ChaosCrash:
                restarts += 1
                continue
            if len(acked) == len(specs) and all(
                j in b_sched.jobs and b_sched.jobs[j].terminal
                for j in acked.values()
            ):
                results = {
                    i: {"state": b_sched.jobs[jid].state,
                        "result": b_sched.jobs[jid].result}
                    for i, jid in acked.items() if jid in b_sched.jobs
                }
                b_sched.journal.close()
                b_sink.close()
                break
        else:
            violations.append(
                f"replication trial did not converge: {len(acked)} of "
                f"{len(specs)} specs ACKed after every recovery attempt"
            )

        # -- invariant E: the deposed primary must not still ACK ----------
        if a_sink is not None and a_journal is not None:
            try:
                a_sink.heartbeat()
                a_journal.append({
                    "t": "note",
                    "msg": "doomed write from the deposed primary",
                })
            except Exception:  # noqa: BLE001 — any failure IS the fence
                pass
            if a_sink.quorum_ok():
                violations.append(
                    "invariant E: deposed primary (epoch "
                    f"{a_sink.epoch}) still reaches its ack quorum "
                    "after the standby promoted — dual-primary window"
                )
            a_sink.close()
            a_journal.close()

        injected = list(rt.injected)
    finally:
        sites.deactivate()
        for rep in replicas:
            try:
                rep.die()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # -- post-mortem checks over B's surviving state ----------------------
    rep = run_fsck(b_dir) if os.path.isdir(b_dir) else None
    if rep is not None:
        for f in rep.corrupt:
            violations.append(
                f"invariant C: fsck {f.kind} at {f.path}: {f.detail}"
            )
    for rd in r_dirs:
        if not (os.path.isdir(b_dir) and os.path.isdir(rd)):
            continue
        cmp_rep = run_compare(b_dir, rd)
        for f in cmp_rep.corrupt:
            violations.append(
                f"invariant C: fsck --compare {f.kind}: {f.detail}"
            )
    for i in sorted(golden):
        got = results.get(i)
        if got is None:
            if "invariant A" not in " ".join(violations) \
                    and "did not converge" not in " ".join(violations):
                violations.append(
                    f"invariant A: spec {i} never reached a terminal "
                    "state on the promoted primary"
                )
            continue
        if _canon(got) != _canon(golden[i]):
            violations.append(
                f"invariant B: spec {i} result diverged from golden "
                f"across the failover (got {_canon(got)[:200]}... want "
                f"{_canon(golden[i])[:200]}...)"
            )
    if not keep_dir:
        shutil.rmtree(root, ignore_errors=True)
    return TrialResult(plan=plan, violations=violations,
                       injected=injected, restarts=restarts)


# ---- the attestation trial (silent corruption vs the fingerprint chain) --

_ATTEST_DEADLINE_S = 300.0
_ATTEST_WORKERS = 4  # headroom: every resolved mismatch quarantines one

#: fault-free pooled reference, memoized across a campaign's trials
_attest_golden_memo: dict = {}


def _canon_pool(rec) -> str:
    """`_canon` for pool unit records: additionally drop the attest
    payload (golden runs attest-off, so chains exist only on one side)
    and the suspects list (bookkeeping, not simulation output)."""

    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in sorted(obj.items())
                    if k not in _NONDET_KEYS + ("attest", "suspects")}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    return json.dumps(strip(rec), sort_keys=True)


def _pool_drain(root, cfg, specs, attest, audit_rate, device,
                n_workers=_ATTEST_WORKERS):
    """One pooled campaign, in-process: coordinator over a real socket,
    worker THREADS sharing this process's chaos runtime (so a plan's
    flip events land inside worker executions). Returns (results,
    counters, suspect_workers)."""
    import threading
    import time as _time

    from ..pool import PoolCoordinator, PoolWorker
    from ..pool.units import build_units

    units = build_units(
        cfg, [], list(specs), [{} for _ in specs],
        fold=True, chunk_steps=16, max_steps=100_000,
    )
    coord = PoolCoordinator(
        units, root, lease_ttl_s=30.0, hedge=False,
        attest=attest, audit_rate=audit_rate,
    )
    coord.start()
    try:
        threads = [
            threading.Thread(
                target=PoolWorker(coord.socket_path, f"w{k}",
                                  reconnect_timeout_s=10.0,
                                  device=device).run,
                daemon=True,
            )
            for k in range(n_workers)
        ]
        for t in threads:
            t.start()
        deadline = _time.monotonic() + _ATTEST_DEADLINE_S
        for t in threads:
            t.join(timeout=max(0.1, deadline - _time.monotonic()))
        results = coord.results()
        counters = dict(coord.counters)
        suspects = set(coord.suspect_workers)
    finally:
        coord.close(drained=coord.done)
    return results, counters, suspects


def attest_golden_run(cfg=None, specs=DEFAULT_SPECS,
                      workdir: str | None = None, device=None) -> dict:
    """Fault-free pooled reference for invariant F: index -> canonical
    unit result, attest OFF (the trial's attest-on results must strip
    down to exactly these bytes)."""
    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    key = (cfg.to_json(), tuple(specs), str(device))
    hit = _attest_golden_memo.get(key)
    if hit is not None:
        return hit
    assert sites.runtime() is None, "golden run must be fault-free"
    tmp = tempfile.mkdtemp(prefix="chaos-attest-golden-", dir=workdir)
    try:
        results, _counters, _suspects = _pool_drain(
            tmp, cfg, specs, attest="off", audit_rate=0.0, device=device,
            n_workers=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for r in results:
        if r["state"] != "DONE":
            raise RuntimeError(
                f"attest golden run: unit {r['unit_id']} ended "
                f"{r['state']}, want DONE"
            )
        out[r["index"]] = _canon_pool(r["result"])
    _attest_golden_memo[key] = out
    return out


def run_attest_trial(
    plan: P.FaultPlan,
    cfg=None,
    specs=DEFAULT_SPECS,
    golden: dict | None = None,
    workdir: str | None = None,
    keep_dir: bool = False,
    device=None,
) -> TrialResult:
    """One seeded trial of the result-integrity story (DESIGN.md §24):
    a pooled campaign with `--attest chain --audit-rate 1.0` under a
    plan of silent-corruption flips, then machine-check

      F. NO CORRUPTED RESULT DONE-UNFLAGGED — every unit that ends DONE
         carries the fault-free golden result; a corrupted execution
         must have been voided (tiebreak re-run) or ended SUSPECT.

    plus the false-positive dual: a trial where NO flip fired must show
    zero mismatches, zero SUSPECT units and zero quarantined workers."""
    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    # `golden` is the serve-shaped reference run_campaign threads
    # through every trial; the pooled reference is its own shape and is
    # memoized per (config, specs) in attest_golden_run
    del golden
    ref = attest_golden_run(cfg, specs, workdir=workdir, device=device)
    tmp = tempfile.mkdtemp(prefix="chaos-attest-", dir=workdir)
    violations: list = []
    rt = sites.install(plan, mode="raise")
    try:
        results, counters, suspects = _pool_drain(
            tmp, cfg, specs, attest="chain", audit_rate=1.0, device=device)
        injected = list(rt.injected)
    finally:
        sites.deactivate()

    fired_flips = [e for e in injected if e["site"] in ATTEST_SITES]
    flagged = 0
    for r in results:
        want = ref.get(r["index"])
        if r["state"] == "DONE":
            if want is not None and _canon_pool(r["result"]) != want:
                violations.append(
                    f"invariant F: unit {r['unit_id']} is DONE with a "
                    f"result diverging from golden and no flag (got "
                    f"{_canon_pool(r['result'])[:200]}... want "
                    f"{want[:200]}...)"
                )
        elif r["state"] == "SUSPECT":
            flagged += 1
            if not fired_flips:
                violations.append(
                    f"false positive: unit {r['unit_id']} ended SUSPECT "
                    "with no corruption injected"
                )
        else:
            violations.append(
                f"attest trial did not converge: unit {r['unit_id']} "
                f"ended {r['state']}"
            )
    if not fired_flips:
        if counters.get("attest_mismatches", 0):
            violations.append(
                "false positive: "
                f"{counters['attest_mismatches']} chain mismatch(es) "
                "with no corruption injected"
            )
        if suspects:
            violations.append(
                f"false positive: workers {sorted(suspects)} quarantined "
                "with no corruption injected"
            )
    if not keep_dir:
        shutil.rmtree(tmp, ignore_errors=True)
    return TrialResult(plan=plan, violations=violations,
                       injected=injected)


# ---- the capacity-loss trial (invariant G, DESIGN.md §26) ----------------

# memoized fault-free reference for the supervisor half, one per device
# and process: the supervised runs under revocation must match it
_CAP_REF: dict = {}


def _capacity_workload():
    from ..config.machine import small_test_config
    from ..trace import synth

    cfg = small_test_config(8, n_banks=8)
    trace = synth.fft_like(8, n_phases=1, points_per_core=12, seed=7)
    return cfg, trace


def _capacity_reference(device) -> dict:
    """Fault-free supervised run of the capacity workload: the bit-exact
    target every degraded run is held to."""
    ref = _CAP_REF.get(str(device))
    if ref is not None:
        return ref
    from ..sim.engine import Engine
    from ..sim.supervisor import RunSupervisor

    assert sites.runtime() is None, "capacity reference must be fault-free"
    cfg, trace = _capacity_workload()
    eng = Engine(cfg, trace, chunk_steps=32, device=device)
    RunSupervisor(eng, handle_signals=False).run()
    ref = {"cycles": eng.cycles.copy(),
           "counters": {k: v.copy() for k, v in eng.counters.items()}}
    _CAP_REF[str(device)] = ref
    return ref


def _capacity_supervisor_half(tmp: str, violations: list, ref: dict,
                              device) -> dict:
    """Run the capacity workload SHARDED under the installed plan's
    `devices.revoke` events and hold the recovered run to the fault-free
    reference (invariant G, bit-exact half). With one visible device the
    revocation clamps to a no-op and the run must simply complete.
    Returns the supervisor's degrade rungs."""
    from ..parallel import sharding
    from ..sim.engine import Engine
    from ..sim.supervisor import RunSupervisor

    cfg, trace = _capacity_workload()
    sharding.restore_devices()  # every trial starts from a healthy pool
    mesh = None
    visible = sharding.visible_devices("gpu" if device.type == "cuda" else "cpu")
    if len(visible) > 1:
        n = sharding.largest_valid_submesh(cfg, len(visible))
        if n > 1:
            mesh = sharding.tile_mesh(devices=visible[:n])
    eng = Engine(cfg, trace, chunk_steps=32, device=device, mesh=mesh)
    sup = RunSupervisor(
        eng, snapshot_dir=os.path.join(tmp, "snaps"),
        checkpoint_every_chunks=1, handle_signals=False,
    )
    try:
        sup.run()
    except BaseException as e:  # noqa: BLE001 — any escape is a violation
        violations.append(
            f"invariant G: supervised run died under device loss: {e!r}"
        )
        return {"degrade_rungs": list(sup.degrade_rungs)}
    finally:
        sharding.restore_devices()
    if not np.array_equal(eng.cycles, ref["cycles"]):
        violations.append(
            "invariant G: cycles diverged after device-loss recovery "
            f"(rungs: {sup.degrade_rungs})"
        )
    for k, v in eng.counters.items():
        if not np.array_equal(v, ref["counters"][k]):
            violations.append(
                f"invariant G: counter {k} diverged after device-loss "
                f"recovery (rungs: {sup.degrade_rungs})"
            )
            break
    return {"degrade_rungs": list(sup.degrade_rungs)}


def run_capacity_trial(
    plan: P.FaultPlan,
    cfg=None,
    specs=DEFAULT_SPECS,
    golden: dict | None = None,
    workdir: str | None = None,
    keep_dir: bool = False,
    buckets=((2, 1),),
    chunk_steps: int = 16,
    device=None,
) -> TrialResult:
    """One seeded capacity-loss trial. Two halves under ONE runtime:

    - `devices.revoke` events fire at supervised chunk boundaries of a
      sharded run; the reshard ladder must keep the result bit-exact
      with the fault-free unsharded reference (with one visible device a
      revocation has nothing to take);
    - `disk.preflight` events open sustained ENOSPC windows under the
      in-process serve stack; the harness retries on `DiskPressureError`
      the way a backpressured client would, and every ACKed job must
      still reach its golden terminal state over a clean journal (fsck).
    """
    from ..analysis.fsck import run_fsck
    from ..util.diskpressure import DiskPressureError

    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    revoke_events = [e for e in plan.events if e.site == "devices.revoke"]
    disk_events = [e for e in plan.events if e.site == "disk.preflight"]
    ref = _capacity_reference(device) if revoke_events else None
    if disk_events and golden is None:
        golden = golden_run(cfg, specs, buckets=buckets,
                            chunk_steps=chunk_steps, workdir=workdir,
                            device=device)
    tmp = tempfile.mkdtemp(prefix="chaos-capacity-", dir=workdir)
    violations: list = []
    acked: dict = {}
    idems = {i: f"chaos-{plan.seed}-{i}" for i in range(len(specs))}
    restarts = 0
    backpressured = 0
    results: dict = {}
    # a sustained window consumes one probe per free-space recheck, so
    # bound the retry loop by the total window budget, not event count
    window_budget = sum(
        max(1, int(e.arg("calls", 3))) for e in disk_events
    )
    rt = sites.install(plan, mode="raise")
    try:
        if revoke_events:
            _capacity_supervisor_half(tmp, violations, ref, device)
        if disk_events:
            while True:
                try:
                    results = _run_to_completion(
                        tmp, cfg, specs, idems, acked, violations,
                        buckets, chunk_steps, device,
                    )
                    break
                except DiskPressureError:
                    # the typed backpressure a live client would absorb:
                    # back off (no real sleep — windows drain per probe)
                    backpressured += 1
                    if backpressured > window_budget + len(plan.events) + 4:
                        violations.append(
                            "invariant G: disk pressure never cleared "
                            f"after {backpressured} backoff rounds"
                        )
                        break
                except sites.ChaosCrash:
                    restarts += 1
                    if restarts > len(plan.events) + 2:
                        violations.append(
                            f"restart loop: {restarts} restarts for "
                            f"{len(plan.events)} planned events"
                        )
                        break
        injected = list(rt.injected)
    finally:
        sites.deactivate()

    rep = run_fsck(tmp)
    for f in rep.corrupt:
        violations.append(
            f"invariant G/C: fsck {f.kind} at {f.path}: {f.detail}"
        )
    if disk_events and golden is not None:
        for i in sorted(golden):
            got = results.get(i)
            if got is None:
                violations.append(
                    f"invariant G/A: spec {i} never reached a terminal "
                    "state under disk pressure"
                )
                continue
            if _canon(got) != _canon(golden[i]):
                violations.append(
                    f"invariant G/B: spec {i} diverged under disk "
                    f"pressure (got {_canon(got)[:200]}...)"
                )
    if not keep_dir:
        shutil.rmtree(tmp, ignore_errors=True)
    return TrialResult(plan=plan, violations=violations,
                       injected=injected, restarts=restarts)


# ---- the campaign --------------------------------------------------------


def _trial_sites(classes) -> tuple[list, set]:
    """(site names plans may use, classes routed to the socket trial)."""
    names: list = []
    socket_only = set()
    for cls in classes:
        for s in SERVE_SITES.get(cls, ()):
            names.append(s)
        if cls == "socket":
            socket_only.add(cls)
    if "replication" in classes:
        names.extend(REPLICATION_SITES)
    if "silent_corruption" in classes:
        names.extend(ATTEST_SITES)
    if "capacity_loss" in classes:
        names.extend(CAPACITY_SITES)
    return names, socket_only


def _gen_classes(classes) -> tuple:
    """Classes handed to the plan generator. `replication` implies the
    replica-kill crashpoint (see REPLICATION_SITES) — the site list
    already narrows the pool, so widening the class filter here cannot
    leak serve-side crashpoints into a replication-only campaign."""
    out = tuple(classes)
    if "replication" in out and "crashpoint" not in out:
        out = out + ("crashpoint",)
    return out


def run_trial(plan, cfg=None, specs=DEFAULT_SPECS, golden=None,
              workdir=None, **kw) -> TrialResult:
    """Dispatch one plan to the harness that can reach its sites: plans
    touching any replication site need the primary+replicas+standby
    topology; plans touching only socket sites go over the wire;
    everything else runs the in-process serve trial (mixed plans run
    in-process, where the socket sites are simply never reached and
    those events stay inert)."""
    if plan.events and any(
        e.site in REPLICATION_SITES for e in plan.events
    ):
        return run_replication_trial(plan, cfg=cfg, specs=specs,
                                     golden=golden, workdir=workdir, **kw)
    if plan.events and any(
        e.site in ATTEST_SITES for e in plan.events
    ):
        # a flip in a serve-trial fleet would be an undetectable bogus
        # invariant-B failure; corruption plans get the attested pool
        return run_attest_trial(plan, cfg=cfg, specs=specs,
                                golden=golden, workdir=workdir, **kw)
    if plan.events and any(
        e.site in CAPACITY_SITES for e in plan.events
    ):
        # device revocation needs a supervised engine and ENOSPC
        # windows need a backpressure-aware client (invariant G)
        return run_capacity_trial(plan, cfg=cfg, specs=specs,
                                  golden=golden, workdir=workdir, **kw)
    if plan.events and all(
        sites.SITES.get(e.site) == "socket" for e in plan.events
    ):
        return run_socket_trial(plan, cfg=cfg, specs=specs,
                                golden=golden, workdir=workdir, **kw)
    return run_serve_trial(plan, cfg=cfg, specs=specs, golden=golden,
                           workdir=workdir, **kw)


def run_campaign(
    n_trials: int = 20,
    seed0: int = 0,
    classes: tuple = ("durable", "crashpoint"),
    cfg=None,
    specs=DEFAULT_SPECS,
    workdir: str | None = None,
    artifact_dir: str | None = None,
    max_events: int = 3,
    progress=None,
    device=None,
) -> dict:
    """N seeded trials; on violation, bisect-shrink the plan to a
    1-minimal event set and write a replayable repro artifact. Returns
    the campaign report (the `chaos` verb's JSON surface)."""
    device = resolve_device(device)
    cfg = cfg or _default_cfg()
    # a pure silent_corruption campaign never runs a serve trial, so
    # its serve-shaped golden would be wasted work
    golden = (golden_run(cfg, specs, workdir=workdir, device=device)
              if any(c != "silent_corruption" for c in classes) else None)
    site_pool, _ = _trial_sites(classes)
    report = {
        "trials": 0, "violations": [], "fired_events": 0,
        "classes": list(classes), "seed0": seed0,
    }
    gen_classes = _gen_classes(classes)
    for k in range(n_trials):
        seed = seed0 + k
        plan = P.generate(seed, classes=gen_classes, sites=site_pool,
                          max_events=max_events)
        res = run_trial(plan, cfg=cfg, specs=specs, golden=golden,
                        workdir=workdir, device=device)
        report["trials"] += 1
        report["fired_events"] += len(res.injected)
        if progress is not None:
            progress(seed, res)
        if res.ok:
            continue

        def still_fails(cand) -> bool:
            return not run_trial(cand, cfg=cfg, specs=specs,
                                 golden=golden, workdir=workdir,
                                 device=device).ok

        shrunk = P.shrink(plan, still_fails)
        final = run_trial(shrunk, cfg=cfg, specs=specs, golden=golden,
                          workdir=workdir, device=device)
        artifact = {
            "seed": seed,
            "plan": shrunk.as_dict(),
            "original_events": len(plan.events),
            "shrunk_events": len(shrunk.events),
            "violations": list(final.violations or res.violations),
            "injected": list(final.injected),
            "repro": "python -m primesim_tpu_torch chaos --plan <this file>",
        }
        path = None
        if artifact_dir:
            os.makedirs(artifact_dir, exist_ok=True)
            path = os.path.join(artifact_dir, f"chaos-repro-{seed}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(artifact, f, indent=2, sort_keys=True)
        artifact["artifact_path"] = path
        report["violations"].append(artifact)
    report["ok"] = not report["violations"]
    return report


def replay_artifact(path: str, cfg=None, specs=DEFAULT_SPECS,
                    workdir=None, device=None) -> TrialResult:
    """Re-run the exact plan a repro artifact (or bare plan JSON)
    carries — the one-line repro loop."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    plan = P.FaultPlan.from_dict(doc.get("plan", doc))
    return run_trial(plan, cfg=cfg, specs=specs, workdir=workdir,
                     device=device)
