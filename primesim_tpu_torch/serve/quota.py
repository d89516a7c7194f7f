"""Per-tenant admission quotas (DESIGN.md §18).

The serve scheduler's priority/fairness tiers order work AFTER
admission; quotas bound what each tenant may admit in the first place.
One token bucket per client id: `rate` tokens/second refill up to
`burst` capacity, one token per accepted submit. A drained bucket
rejects with `QuotaExceeded` carrying `retry_after_s` — the exact time
until one token exists — so well-behaved clients back off precisely
instead of hammering (the same structured-backpressure shape QueueFull
uses, and `ServeClient.submit(retries=...)` already honors it).

The bucket is deliberately NOT durable: a front-end restart refills
everyone. Quotas protect the service's admission rate, not a billing
ledger — forgiving a crash window is the right failure mode.

The JAX package's `serve/quota.py`, copied whole for the port (it touches no
device), so the two packages' daemons, clients and state directories
speak one protocol and one journal format.
"""

from __future__ import annotations

import threading
import time


class QuotaExceeded(RuntimeError):
    """Per-tenant admission rate exceeded. `retry_after_s` is the exact
    delay until the tenant's bucket holds one token again."""

    def __init__(self, client: str, retry_after_s: float):
        super().__init__(
            f"client {client!r} exceeded its admission quota; retry in "
            f"{retry_after_s:.2f}s"
        )
        self.client = client
        self.retry_after_s = retry_after_s


class TenantQuota:
    """Token buckets for every tenant under one (rate, burst) policy.
    `clock` is injectable so tests don't sleep."""

    def __init__(self, rate: float, burst: float | None = None,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"quota rate must be positive, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(
            1.0, self.rate
        )
        if self.burst < 1.0:
            raise ValueError(
                f"burst {self.burst} < 1 token: nothing could ever submit"
            )
        self.clock = clock
        self.rejections = 0
        self._lock = threading.Lock()
        self._buckets: dict[str, tuple[float, float]] = {}  # client ->
        #   (tokens, last refill time)

    def admit(self, client: str) -> None:
        """Spend one token for `client` or raise QuotaExceeded."""
        client = str(client or "anon")
        now = self.clock()
        with self._lock:
            tokens, last = self._buckets.get(client, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens >= 1.0:
                self._buckets[client] = (tokens - 1.0, now)
                return
            self._buckets[client] = (tokens, now)
            self.rejections += 1
        raise QuotaExceeded(client, (1.0 - tokens) / self.rate)

    @staticmethod
    def parse(spec: str) -> "TenantQuota":
        """CLI form `RATE` or `RATE:BURST` (e.g. `2`, `0.5:10`)."""
        rate, _, burst = str(spec).partition(":")
        return TenantQuota(float(rate), float(burst) if burst else None)
