"""`serve` — the daemon around the scheduler (DESIGN.md §14), the JAX
package's `serve/server.py` for the port: in its local mode one process
owns the buckets' fleets on its device; in its dispatch mode
(`pool_dir`, DESIGN.md §18) jobs run on an autoscaling pool of worker
processes (`serve/dispatch.py`).

Threading model: listener threads (socketserver.ThreadingMixIn over a
unix stream socket) PARSE requests and enqueue closures onto the
scheduler inbox; the main thread runs the serve loop (tick + inbox
drain) and owns every mutable structure, so the scheduler stays
single-threaded and signal handling stays on the main thread. Replies
that need scheduler state are fulfilled via per-request Events.

Signals:
    SIGTERM/SIGINT  graceful drain — stop admissions, checkpoint every
                    in-flight job, journal the drain marker, exit 75
                    (EX_TEMPFAIL, same "rerun to continue" contract as
                    the supervisor's Preempted path) when work remains,
                    0 when the queue finished.
    SIGHUP          reload the config file (fault schedules etc.); the
                    reloaded config must normalize to the SAME geometry
                    key — traced knobs may change, compiled shapes may
                    not. Applies to subsequently admitted jobs.

Restart: `PrimeServer(...)` replays the journal before listening. Every
ACKed job is either terminal (kept for STATUS/RESULT) or re-enqueued,
resuming from its newest per-job element checkpoint when one exists —
`kill -9` at ANY instant loses no accepted job.

Replication (DESIGN.md §21, `replicate.py`): with `replicas` the
journal streams every frame to follower `replica` daemons, a submit is
ACKed only once its accept record reached the quorum, the serve loop
sends a heartbeat every 0.25 s, and a primary fenced by a promoted
standby's higher epoch stops serving and exits 75. It works alike in
the local and the dispatch mode.
"""

from __future__ import annotations

import os
import queue
import signal
import socketserver
import threading
import time

from . import jobs as J
from .journal import JobJournal, fold_records, serve_compactor
from .protocol import (
    encode,
    error_obj,
    make_listener,
    parse_target,
    read_line,
)
from ..util.diskpressure import DiskPressureError
from .quota import QuotaExceeded, TenantQuota
from .replicate import PrimaryFenced, ReplicaQuorumLost
from .scheduler import DEFAULT_BUCKETS, QueueFull, Scheduler

EX_TEMPFAIL = 75  # drained with work remaining; restart to continue


class _Request:
    """One parsed client request awaiting the main loop: `fn` runs ON the
    scheduler thread and returns the reply dict."""

    def __init__(self, fn):
        self.fn = fn
        self.reply: dict | None = None
        self.done = threading.Event()


class PrimeServer:
    def __init__(
        self,
        cfg,
        state_dir: str,
        socket_path: str | None = None,
        buckets=DEFAULT_BUCKETS,
        chunk_steps: int = 128,
        max_queue: int = 64,
        checkpoint_every_s: float = 2.0,
        config_path: str | None = None,
        idle_exit_s: float | None = None,
        obs=None,
        warm_cache: bool = False,
        quota: TenantQuota | None = None,
        attest: str = "off",
        device=None,
        pool_dir: str | None = None,
        max_workers: int = 2,
        lease_ttl_s: float = 10.0,
        spawn_pool: bool = True,
        audit_rate: float = 0.0,
        replicas: list[str] | tuple[str, ...] | None = None,
        quorum: int | None = None,
        quorum_policy: str = "block",
        node: str | None = None,
        devices: int = 0,
    ):
        self.state_dir = str(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.socket_path = socket_path or os.path.join(
            self.state_dir, "serve.sock"
        )
        self.config_path = config_path
        self.idle_exit_s = idle_exit_s
        self.obs = obs
        self.quota = quota
        self.journal = JobJournal(self.state_dir, compactor=serve_compactor)
        self.journal.obs = obs
        self.repl = None
        if replicas:
            # replicated journal + fencing (DESIGN.md §21): attach the
            # sink BEFORE recovery so the epoch frame that opens this
            # reign is both the first record of the reign and the first
            # frame the followers see from us
            from .replicate import ReplicationSink

            self.repl = ReplicationSink(
                self.journal, list(replicas), quorum=quorum,
                policy=quorum_policy, obs=obs,
                node=node or f"serve-{os.getpid()}",
            )
            self.journal.sink = self.repl
            self.repl.begin_epoch()
        if pool_dir:
            # dispatch mode: jobs run on an autoscaling worker fleet via
            # a (spawned or adopted) pool coordinator — DESIGN.md §18
            from .dispatch import DispatchScheduler

            self.sched = DispatchScheduler(
                cfg,
                self.journal,
                self.state_dir,
                pool_dir,
                buckets=buckets,
                chunk_steps=chunk_steps,
                max_queue=max_queue,
                max_workers=max_workers,
                lease_ttl_s=lease_ttl_s,
                obs=obs,
                spawn=spawn_pool,
                attest=attest,
                audit_rate=audit_rate,
                device=device,
                devices=devices,
            )
        else:
            if devices:
                # caller contract, not a user-reachable path: the serve verb
                # rejects --devices without --pool-dir before constructing
                raise ValueError(
                    "serve --devices needs dispatch mode (--pool-dir): "
                    "sharded fleets live on pool workers, not in the "
                    "front-end process"
                )
            self.sched = Scheduler(
                cfg,
                self.journal,
                self.state_dir,
                buckets=buckets,
                chunk_steps=chunk_steps,
                max_queue=max_queue,
                checkpoint_every_s=checkpoint_every_s,
                obs=obs,
                warm_cache=warm_cache,
                attest=attest,
                device=device,
            )
        self.inbox: "queue.Queue[_Request]" = queue.Queue()
        self._draining = False
        self._stop = False
        self.recovered = self._recover()
        self._srv = None

    # ---- crash recovery --------------------------------------------------

    def _recover(self) -> dict:
        """Replay the journal into the scheduler's job table. Terminal
        jobs are adopted for queries; non-terminal ones re-enqueue (with
        checkpoint resume). Returns recovery stats for healthz/logs."""
        records, dropped = self.journal.replay()
        jobs, clean = fold_records(records)
        requeued = 0
        for job in jobs.values():
            if job.terminal:
                self.sched.adopt_terminal(job)
            else:
                self.sched.requeue_recovered(job)
                requeued += 1
        if jobs:
            self.sched._seq = max(
                (int(j.job_id[1:]) for j in jobs.values()
                 if j.job_id.startswith("j") and j.job_id[1:].isdigit()),
                default=0,
            )
        stats = {
            "journal_records": len(records),
            "torn_tail_dropped": dropped,
            "jobs_replayed": len(jobs),
            "jobs_requeued": requeued,
            "clean_drain": clean,
        }
        if records:
            self.journal.note(f"recovered: {stats}")
        return stats

    # ---- request handlers (run on the scheduler thread) ------------------

    def _handle(self, req: dict) -> dict:
        verb = req.get("verb")
        try:
            if verb == "submit":
                return self._h_submit(req)
            if verb == "status":
                return self._h_status(req)
            if verb == "result":
                return self._h_result(req)
            if verb == "cancel":
                job = self.sched.cancel(str(req["job_id"]))
                return {"ok": True, "job": job.public()}
            if verb == "health":
                return self._h_health()
            if verb == "metrics":
                return self._h_metrics()
            if verb == "drain":
                self._draining = True
                return {"ok": True, "draining": True}
            raise ValueError(f"unknown verb {verb!r}")
        except (QueueFull, QuotaExceeded, ReplicaQuorumLost,
                DiskPressureError) as e:
            out = {"ok": False, "retry_after_s": round(e.retry_after_s, 1)}
            out.update(error_obj(e))
            return out
        except PrimaryFenced as e:
            # a standby promoted past us: refuse, and let the serve
            # loop turn the fence into exit 75 on its next pass
            out = {"ok": False, "fenced": True}
            out.update(error_obj(e))
            return out
        except Exception as e:  # noqa: BLE001 — protocol boundary
            out = {"ok": False}
            out.update(error_obj(e))
            return out

    def _h_submit(self, req: dict) -> dict:
        if self._draining:
            out = {"ok": False, "retry_after_s": 5.0}
            out.update(error_obj(RuntimeError("server is draining")))
            return out
        if self.repl is not None:
            # quorum gate BEFORE a job id exists: under `block`, a
            # below-quorum primary refuses admission (typed
            # backpressure); a fenced one refuses, period
            self.repl.check_admission()
        idem = req.get("idem")
        if idem:
            # idempotent resubmit: a client retrying after a lost ACK
            # (or a duplicated frame) presents the same token; answer
            # with the already-accepted job. Tokens ride the accept
            # record, so the dedup also holds across a server restart.
            for j in self.sched.jobs.values():
                if j.idem == str(idem) \
                        and j.client == str(req.get("client", "anon")):
                    return {"ok": True, "job": j.public(),
                            "duplicate": True}
        if self.quota is not None:
            # admission quota spends a token BEFORE a job id exists, so
            # rejected submits leave no trace in the journal or job table
            self.quota.admit(str(req.get("client", "anon")))
        job = J.Job(
            job_id=self.sched.next_job_id(),
            idem=str(idem) if idem else None,
            client=str(req.get("client", "anon")),
            trace_path=req.get("trace_path"),
            synth=req.get("synth"),
            overrides=dict(req.get("overrides") or {}),
            fold=bool(req.get("fold", True)),
            deadline_s=(
                float(req["deadline_s"])
                if req.get("deadline_s") is not None else None
            ),
            max_steps=int(req.get("max_steps", 10_000_000)),
            priority=int(req.get("priority", 0)),
        )
        self.sched.submit(job)  # fsyncs the accept record before returning
        if self.repl is not None and not self.repl.quorum_ok() \
                and self.repl.policy == "block":
            # the accept record is on OUR disk but missed quorum: do
            # not ACK a frame a host-loss failover would forget. The
            # job stays admitted locally; the client's idempotent retry
            # dedups to it once quorum is back (and if we die first,
            # "never ACKed" and "not on the replicas" agree).
            raise ReplicaQuorumLost(
                f"accept record for {job.job_id} missed the replication "
                f"quorum of {self.repl.quorum}; retry with the same "
                "idempotency token", self.repl.retry_after_s,
            )
        return {"ok": True, "job": job.public()}

    def _h_status(self, req: dict) -> dict:
        job_id = req.get("job_id")
        if job_id:
            job = self.sched.jobs.get(str(job_id))
            if job is None:
                raise KeyError(f"unknown job {job_id!r}")
            return {"ok": True, "job": job.public()}
        return {
            "ok": True,
            "jobs": [
                j.public() for j in self.sched.jobs.values()
            ],
        }

    def _h_result(self, req: dict) -> dict:
        job = self.sched.jobs.get(str(req["job_id"]))
        if job is None:
            raise KeyError(f"unknown job {req['job_id']!r}")
        if not job.terminal:
            return {"ok": True, "pending": True, "job": job.public()}
        return {"ok": True, "job": job.public()}

    def _h_health(self) -> dict:
        out = {"ok": True, "draining": self._draining}
        out.update(self.sched.stats())
        out["recovered"] = self.recovered
        if self.quota is not None:
            out["quota"] = {"rate": self.quota.rate,
                            "burst": self.quota.burst,
                            "rejections": self.quota.rejections}
        out["journal"] = {
            "appends": self.journal.appended,
            "fsync_count": self.journal.fsync_hist.count,
            "fsync_total_s": round(self.journal.fsync_hist.sum, 6),
        }
        if self.repl is not None:
            out["replication"] = self.repl.status()
        # the port's own: the device work behind the service
        out["device"] = self.sched.device_stats()
        return out

    def _h_metrics(self) -> dict:
        """Prometheus text exposition of the live scheduler/journal
        state — scrape with `primetpu serve-status --metrics` or any
        client speaking the line protocol."""
        from ..obs.prom import render_prometheus

        text = render_prometheus(
            self.sched, journal=self.journal,
            draining=self._draining, recovered=self.recovered,
            quota=self.quota, repl=self.repl,
        )
        return {"ok": True, "content_type":
                "text/plain; version=0.0.4", "text": text}

    # ---- signals ---------------------------------------------------------

    def _install_signals(self) -> None:
        def _drain(signum, frame):
            self._draining = True
            self._stop = True

        def _reload(signum, frame):
            # flag only — the reload itself runs on the scheduler thread
            self._reload_requested = True

        self._reload_requested = False
        try:
            signal.signal(signal.SIGTERM, _drain)
            signal.signal(signal.SIGINT, _drain)
            if hasattr(signal, "SIGHUP"):
                signal.signal(signal.SIGHUP, _reload)
        except ValueError:
            # not the main thread (in-process tests drive the loop from a
            # worker thread); signal-driven drain simply isn't armed
            pass

    def reload_config(self) -> None:
        """SIGHUP: re-read the config file; traced knobs (fault schedules,
        seeds, rates) may change freely, the geometry key may not —
        admission would need a recompile, which serving forbids."""
        if not self.config_path:
            self.journal.note("SIGHUP ignored: no --config file to reload")
            return
        from ..cli import _load_config  # the port's own loader

        try:
            new_cfg = _load_config(self.config_path)
        except Exception as e:  # noqa: BLE001 — keep serving on bad reload
            self.journal.note(
                f"SIGHUP reload failed ({type(e).__name__}: {e}); "
                "keeping previous config"
            )
            return
        old_key = self.sched.cfg.timing_normalized()
        if new_cfg.timing_normalized() != old_key:
            self.journal.note(
                "SIGHUP reload REJECTED: new config changes the compiled "
                "geometry; restart the server instead"
            )
            return
        self.sched.cfg = new_cfg
        for b in self.sched.buckets:
            b.cfg = new_cfg
        self.journal.note(f"SIGHUP: reloaded config from {self.config_path}")

    # ---- listener --------------------------------------------------------

    def _make_listener(self):
        server = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = read_line(self.rfile)
                    except ValueError as e:
                        self.wfile.write(
                            encode({"ok": False, **error_obj(e)})
                        )
                        return
                    if req is None:
                        return
                    if req.get("verb") == "wait":
                        reply = server._wait_reply(req)
                    else:
                        r = _Request(lambda req=req: server._handle(req))
                        server.inbox.put(r)
                        r.done.wait(timeout=600.0)
                        reply = r.reply or {
                            "ok": False,
                            **error_obj(TimeoutError("server busy")),
                        }
                    try:
                        self.wfile.write(encode(reply))
                        self.wfile.flush()
                    except (BrokenPipeError, ValueError):
                        return

        listener, fam = make_listener(self.socket_path, Handler)
        if fam == "tcp":
            # --tcp HOST:0 binds an ephemeral port; expose the real one
            host, port = listener.server_address[:2]
            self.socket_path = f"{host}:{port}"
        return listener

    def bind(self) -> str:
        """Bind the listener now (idempotent) and return the resolved
        target — the CLI prints its readiness line from this, so a
        `--tcp HOST:0` caller learns the kernel-assigned port."""
        if self._srv is None:
            self._srv = self._make_listener()
        return self.socket_path

    def _wait_reply(self, req: dict) -> dict:
        """`wait` blocks the LISTENER thread (never the scheduler) by
        polling job state through cheap status requests."""
        deadline = time.time() + float(req.get("timeout_s", 300.0))
        job_id = str(req.get("job_id", ""))
        while True:
            r = _Request(
                lambda: self._handle({"verb": "status", "job_id": job_id})
            )
            self.inbox.put(r)
            r.done.wait(timeout=600.0)
            reply = r.reply or {}
            job = (reply or {}).get("job")
            if not reply.get("ok", False):
                return reply
            if job and job["state"] in J.TERMINAL_STATES:
                return reply
            if time.time() >= deadline:
                return {
                    "ok": False,
                    **error_obj(TimeoutError(
                        f"{job_id} not terminal within wait timeout"
                    )),
                }
            time.sleep(0.05)

    # ---- main loop -------------------------------------------------------

    def _drain_inbox(self) -> None:
        while True:
            try:
                r = self.inbox.get_nowait()
            except queue.Empty:
                return
            try:
                r.reply = r.fn()
            except Exception as e:  # noqa: BLE001 — never kill the loop
                r.reply = {"ok": False, **error_obj(e)}
            finally:
                r.done.set()

    def serve_forever(self) -> int:
        """Run until drained (SIGTERM/SIGINT/drain verb) or, with
        idle_exit_s, until the queue has been empty that long. Returns
        the process exit code (0 all work finished, EX_TEMPFAIL=75 when
        unfinished jobs were checkpointed for the next server)."""
        self._install_signals()
        self.bind()
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        idle_since = time.time()
        fenced = False
        last_hb = 0.0
        try:
            while not self._stop:
                if self._reload_requested:
                    self._reload_requested = False
                    self.reload_config()
                if self.repl is not None:
                    now = time.time()
                    if now - last_hb >= 0.25:
                        last_hb = now
                        self.repl.heartbeat()
                    if self.repl.fenced:
                        # a higher epoch ACKed: self-fence. Stop ACKing
                        # NOW and leave with the supervisor contract's
                        # "rerun to continue" code — except rerunning
                        # this node rejoins as a follower, not a primary
                        fenced = True
                        self.journal.note(
                            "fenced by epoch "
                            f"{getattr(self.repl, 'fenced_by', 0)}; "
                            "self-deposing"
                        )
                        break
                self._drain_inbox()
                worked = self.sched.tick()
                busy = worked or self.sched.pending_work()
                if busy:
                    idle_since = time.time()
                elif self._draining:
                    break  # drain verb: queue ran dry, clean exit
                elif (
                    self.idle_exit_s is not None
                    and time.time() - idle_since >= self.idle_exit_s
                ):
                    break
                if not worked:
                    time.sleep(0.01)
        finally:
            self._srv.shutdown()
            self._srv.server_close()
            if parse_target(self.socket_path)[0] == "unix":
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass
        unfinished = self.sched.drain()
        if hasattr(self.sched, "shutdown_children"):
            self.sched.shutdown_children()
        self._drain_inbox()  # flush replies so clients aren't left hanging
        if self.repl is not None:
            self.repl.close()
        self.journal.close()
        # a fenced primary always exits 75: its remaining work belongs
        # to the new primary's reign, never to a local rerun as primary
        return EX_TEMPFAIL if (unfinished or fenced) else 0
