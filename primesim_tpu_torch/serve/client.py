"""Client for a running `primetpu serve` daemon — thin verb wrappers over
the JSON-lines protocol, used by `primetpu submit` / `primetpu
serve-status` and directly by tests.

Targets are either a unix-socket path or `host:port` (the TCP
front-end). Resilience contract:

- CONNECT-phase failures (`ServeUnavailable` — nothing was sent) retry
  under decorrelated-jitter backoff for any verb: the retry cannot
  double-submit because the server never saw the request.
- POST-SEND failures (plain ConnectionError/OSError — the connection
  died after bytes left, so the request MAY have been handled and its
  ACK lost) retry only for verbs marked idempotent. `max_reconnects`
  defaults to 1 so an interactive CLI reports a dead daemon quickly;
  long-lived callers (chaos trials, batch drivers) raise it. Reads (status,
  result, wait, health, metrics) are naturally idempotent; `submit` is
  MADE idempotent by a client-generated idempotency token — the server
  answers a retried token with the already-accepted job instead of
  enqueueing a twin. `cancel` stays single-shot.

The JAX package's `serve/client.py`, copied whole for the port (it touches no
device), so the two packages' daemons, clients and state directories
speak one protocol and one journal format.
"""

from __future__ import annotations

import time
import uuid

from ..util.backoff import DecorrelatedJitter, jittered
from .protocol import ServeUnavailable, request


class ServeError(RuntimeError):
    """Server replied `ok: false`. Carries the structured error object
    and the backpressure hint when one was offered."""

    def __init__(self, reply: dict):
        err = reply.get("error") or {}
        super().__init__(err.get("detail") or "server error")
        self.reply = reply
        self.error = err
        self.retry_after_s = reply.get("retry_after_s")


class ServeClient:
    def __init__(self, target: str, timeout_s: float = 30.0,
                 connect_timeout_s: float = 5.0,
                 max_reconnects: int = 1, rng=None):
        # `target` may be a comma-separated failover list ("primary,
        # standby"): a connect-phase failure rotates to the next entry,
        # so a watched/submitting client rides out a promotion instead
        # of dying with the old primary
        self.targets = [t.strip() for t in str(target).split(",")
                        if t.strip()] or [str(target)]
        self._ti = 0
        self.target = self.targets[0]
        self.socket_path = self.target  # legacy alias (pre-TCP callers)
        self.timeout_s = float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_reconnects = int(max_reconnects)
        self.rng = rng
        self.reconnects = 0  # observable retry count (tests/diagnostics)

    def _call(self, req: dict, timeout_s: float | None = None,
              idempotent: bool = False) -> dict:
        """One verb round-trip under the resilience contract above."""
        jitter = DecorrelatedJitter(base=0.2, cap=3.0, rng=self.rng)
        attempt = 0
        while True:
            try:
                reply = self._request(req, timeout_s)
                break
            except ServeUnavailable:
                # connect never completed: always safe to retry — on
                # the NEXT target of the failover list when one exists
                self._rotate()
                if attempt >= self.max_reconnects:
                    raise
            except (ConnectionError, OSError):
                # post-send: the server may have handled the request and
                # the reply died on the wire — only a token-carrying or
                # read-only request may be replayed
                if not idempotent or attempt >= self.max_reconnects:
                    raise
                self._rotate()
            attempt += 1
            self.reconnects += 1
            time.sleep(jitter.next_delay())
        if not reply.get("ok", False):
            raise ServeError(reply)
        return reply

    def _rotate(self) -> None:
        if len(self.targets) > 1:
            self._ti = (self._ti + 1) % len(self.targets)
            self.target = self.targets[self._ti]

    def _request(self, req: dict, timeout_s: float | None) -> dict:
        return request(
            self.target, req,
            timeout_s=self.timeout_s if timeout_s is None else timeout_s,
            connect_timeout_s=self.connect_timeout_s,
        )

    def submit(
        self,
        trace_path: str | None = None,
        synth: str | None = None,
        overrides: dict | None = None,
        fold: bool = True,
        deadline_s: float | None = None,
        max_steps: int = 10_000_000,
        priority: int = 0,
        client: str = "anon",
        retries: int = 0,
        idem: str | None = None,
    ) -> dict:
        """Submit one job; the reply's job is ACKed = durably journaled.
        A fresh idempotency token is generated unless `idem` is given,
        so transparent reconnect-retries cannot double-enqueue. With
        `retries`, honors RETRY_AFTER backpressure by sleeping and
        resubmitting up to that many times."""
        req = {
            "verb": "submit",
            "trace_path": trace_path,
            "synth": synth,
            "overrides": dict(overrides or {}),
            "fold": fold,
            "deadline_s": deadline_s,
            "max_steps": max_steps,
            "priority": priority,
            "client": client,
            "idem": idem or uuid.uuid4().hex,
        }
        attempt = 0
        while True:
            try:
                return self._call(req, idempotent=True)["job"]
            except ServeError as e:
                if e.retry_after_s is None or attempt >= retries:
                    raise
                attempt += 1
                # jitter the server's hint (util.backoff): N clients told
                # "retry in 5s" must not resubmit in the same instant
                time.sleep(jittered(float(e.retry_after_s), rng=self.rng))

    def status(self, job_id: str | None = None) -> dict | list:
        reply = self._call({"verb": "status", "job_id": job_id},
                           idempotent=True)
        return reply["job"] if job_id else reply["jobs"]

    def result(self, job_id: str) -> dict:
        return self._call({"verb": "result", "job_id": job_id},
                          idempotent=True)

    def wait(self, job_id: str, timeout_s: float = 300.0) -> dict:
        """Block until the job is terminal; returns its public view."""
        reply = self._call(
            {"verb": "wait", "job_id": job_id, "timeout_s": timeout_s},
            timeout_s=timeout_s + 10.0,
            idempotent=True,
        )
        return reply["job"]

    def cancel(self, job_id: str) -> dict:
        return self._call({"verb": "cancel", "job_id": job_id})["job"]

    def health(self) -> dict:
        return self._call({"verb": "health"}, idempotent=True)

    def metrics(self) -> str:
        """Prometheus text exposition from the daemon's `metrics` verb."""
        return self._call({"verb": "metrics"}, idempotent=True)["text"]

    def drain(self) -> dict:
        return self._call({"verb": "drain"}, idempotent=True)
