"""Shared retry backoff: decorrelated jitter (DESIGN.md §17), the JAX
package's `util/backoff.py` for the port.

When one fault front knocks N supervised runs over at the same instant,
deterministic doubling keeps their retries phase-locked. Decorrelated
jitter breaks the lock:

    delay(0)   = base
    delay(n+1) = min(cap, uniform(base, delay(n) * 3))

The expected delay still grows geometrically, but two runs that failed
together draw independent sleeps at once. Given the same `rng` state the
schedule is the JAX package's, draw for draw.
"""

from __future__ import annotations

import random


class DecorrelatedJitter:
    """Stateful backoff schedule: call `next_delay()` per failed attempt,
    `reset()` after a success. An explicit `rng` (any random.Random) makes
    the schedule reproducible; by default each instance draws from its own
    stream seeded by the system RNG."""

    def __init__(self, base: float = 0.5, cap: float = 30.0, rng=None):
        if base <= 0 or cap < base:
            raise ValueError(
                f"backoff needs 0 < base <= cap, got base={base} cap={cap}"
            )
        self.base = float(base)
        self.cap = float(cap)
        self._rng = rng if rng is not None else random.Random()
        self._prev = 0.0

    def next_delay(self) -> float:
        """The next sleep in seconds: uniform over [base, 3*prev], capped.
        The first call returns `base` exactly."""
        if self._prev <= 0.0:
            self._prev = self.base
        else:
            self._prev = min(
                self.cap, self._rng.uniform(self.base, self._prev * 3.0)
            )
        return self._prev

    def reset(self) -> None:
        """Back to the initial state after a success."""
        self._prev = 0.0


def jittered(hint: float, spread: float = 0.5, rng=None) -> float:
    """Spread a server-supplied delay hint uniformly over
    [hint*(1-spread), hint*(1+spread)] so N clients told to come back in
    the same number of seconds don't all come back in the same instant."""
    h = max(0.0, float(hint))
    if h == 0.0 or spread <= 0.0:
        return h
    r = rng if rng is not None else random
    return r.uniform(h * (1.0 - spread), h * (1.0 + spread))
