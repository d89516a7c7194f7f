"""Disk-pressure governance (DESIGN.md §26), the JAX package's
`util/diskpressure.py` for the port.

Every durable surface of the port (rotating checkpoint snapshots, the
warm-state cache) consults this one byte-budget authority before it
writes:

- **one budget** (`configure(budget_bytes=...)`, the CLI's
  `--cache-budget`) bounds the governed artifact pool;
  `checkpoint.prune_warm_cache` reads it before the
  `PRIMETPU_CACHE_MAX_BYTES` environment variable;
- **preflight** (`preflight(path, need_bytes, kind)`) runs inside
  `checkpoint.atomic_save_npz` before the temp file exists. When free
  space cannot cover the write, it runs the ladder;
- **the ladder**: registered evictors, cheapest to recreate first
  (caches at priority 0, rotated snapshots at priority 1), then
  registered compactors, and only when both fail the typed
  `DiskPressureError` with a `retry_after_s` hint. A full disk degrades
  a run (the supervisor skips a rotation); it does not crash it.

The registries are the port's own, separate from the JAX module's. The
JAX module's chaos `disk.preflight` site (a plan event that makes
preflight see zero free bytes) is not ported yet: `free_bytes` reads the
filesystem only.
"""

from __future__ import annotations

import os
import shutil

#: free-bytes floor kept on the filesystem beyond the write itself
DEFAULT_HEADROOM_BYTES = 8 << 20

_BUDGET: int | None = None
_HEADROOM: int = DEFAULT_HEADROOM_BYTES

# name -> (priority, fn); fn(need_bytes) -> freed (best effort: the
# ladder rechecks real free space after every rung)
_EVICTORS: dict[str, tuple[int, object]] = {}
# name -> fn; fn() -> None
_COMPACTORS: dict[str, object] = {}

_IN_LADDER = False  # reentrancy guard: ladder work may itself write

stats = {
    "preflights": 0,
    "pressure_events": 0,
    "evictions_run": 0,
    "compactions_run": 0,
    "rejections": 0,
}


class DiskPressureError(OSError):
    """A disk that stayed full after the whole evict -> compact ladder
    ran. Carries a `retry_after_s` hint, so a full disk sheds load
    instead of killing the run."""

    def __init__(self, detail: str, *, path: str | None = None,
                 need_bytes: int = 0, retry_after_s: float = 2.0):
        super().__init__(detail)
        self.path = path
        self.need_bytes = int(need_bytes)
        self.retry_after_s = float(retry_after_s)

    def location(self) -> dict:
        loc: dict = {"need_bytes": self.need_bytes}
        if self.path is not None:
            loc["path"] = self.path
        return loc


def configure(budget_bytes: int | None = None,
              headroom_bytes: int | None = None) -> None:
    """Set the process-wide governed byte budget (None = environment or
    default) and optionally the free-space headroom floor."""
    global _BUDGET, _HEADROOM
    _BUDGET = int(budget_bytes) if budget_bytes is not None else None
    if headroom_bytes is not None:
        _HEADROOM = int(headroom_bytes)


def budget() -> int | None:
    """The configured byte budget (None when only the environment
    variable or the built-in default applies)."""
    return _BUDGET


def register_evictor(name: str, fn, priority: int = 0) -> None:
    """Register a pressure evictor. Priority 0 = re-derivable caches
    (evicted first), 1 = rotated snapshots (never the newest). A name
    used again replaces its registration."""
    _EVICTORS[name] = (int(priority), fn)


def register_compactor(name: str, fn) -> None:
    """Register a compaction step (runs after every evictor)."""
    _COMPACTORS[name] = fn


def unregister(name: str) -> None:
    _EVICTORS.pop(name, None)
    _COMPACTORS.pop(name, None)


def free_bytes(path: str) -> int:
    """Free bytes on `path`'s filesystem. (The JAX module's chaos
    `disk.preflight` site, which reports zero here while a plan's ENOSPC
    window is open, joins with the chaos sites.)"""
    probe = path if os.path.isdir(path) else (os.path.dirname(path) or ".")
    try:
        return int(shutil.disk_usage(probe).free)
    except OSError:
        # an unstattable target fails at write time with a better error
        return 1 << 62


def _default_cache_evictor(need_bytes: int) -> int:
    """The always-present priority-0 rung: drop the warm-state cache
    (re-derivable: a cold cache only costs recompute). Imported here:
    checkpoint.py imports this module."""
    from ..sim.checkpoint import prune_warm_cache, warm_cache_root

    return prune_warm_cache(warm_cache_root(), max_bytes=0)


def preflight(path: str, need_bytes: int, kind: str = "artifact") -> None:
    """Free-space gate before a durable write of ~`need_bytes` to `path`.
    Returns when the write can proceed; otherwise runs the evict ->
    compact ladder and, if the disk is still full, raises
    `DiskPressureError`. Reentrant calls pass straight through."""
    global _IN_LADDER
    if _IN_LADDER:
        return
    stats["preflights"] += 1
    need = int(need_bytes) + _HEADROOM
    if free_bytes(path) >= need:
        return
    stats["pressure_events"] += 1
    _IN_LADDER = True
    try:
        rungs = sorted(
            [(prio, name, fn) for name, (prio, fn) in _EVICTORS.items()]
            + [(0, "cache-lru", _default_cache_evictor)],
            key=lambda r: (r[0], r[1]),
        )
        for _prio, _name, fn in rungs:
            try:
                fn(need)
            except Exception:  # noqa: BLE001 — eviction is best-effort
                pass
            stats["evictions_run"] += 1
            if free_bytes(path) >= need:
                return
        for name in sorted(_COMPACTORS):
            try:
                _COMPACTORS[name]()
            except Exception:  # noqa: BLE001 — compaction is best-effort
                pass
            stats["compactions_run"] += 1
            if free_bytes(path) >= need:
                return
    finally:
        _IN_LADDER = False
    stats["rejections"] += 1
    raise DiskPressureError(
        f"disk pressure: {kind} write of ~{int(need_bytes)} bytes to "
        f"{path} cannot proceed ({free_bytes(path)} free after "
        "evict+compact ladder); retry after backpressure window",
        path=path,
        need_bytes=int(need_bytes),
        retry_after_s=2.0,
    )
