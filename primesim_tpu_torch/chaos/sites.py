"""The fault-site registry and the hooks threaded through real I/O: the
JAX package's `chaos/sites.py` for the port.

A SITE is a named point in the serving stack where infrastructure can
fail: a durable write, a socket operation, a process crashpoint, a
committed value that silently changes, a disk that fills. The static
catalog (`SITES`) maps each name to its fault class; `plan.generate`
draws events from it.

Activation model: a module-level `ChaosRuntime` (`install(plan)`), or
None. Every hook starts with `if _RT is None: return` — with no plan
active the entire subsystem is one predictable branch per site, adds no
measurable overhead, and the stack stays bit-exact. One runtime spans a
whole TRIAL, surviving in-process "restarts" of the component under
test: occurrence counters keep climbing and fired events never re-fire,
which both makes trials deterministic and bounds them (a plan with K
crash events causes at most K restarts).

Crash semantics: injected process death raises `ChaosCrash`, which
inherits **BaseException** on purpose — the serve/pool protocol
boundaries catch `Exception` to convert handler errors into structured
replies, and a fault that those boundaries could swallow would be a
simulated crash that the process survives. In `mode="kill"` (subprocess
trials, env activation) the hook delivers a real SIGKILL instead.

The catalog is the JAX package's, site for site, so a seed expands to
the same plan in both packages and a plan file of either names sites the
other knows. The port threads all of them: the durable writes of the
journal, of checkpoints and of the kernel build cache's entries
(`exec_cache.write`, sim/exec_cache.py: a fault there costs the entry,
never the run), the client's socket, the serving
daemon's, the pool's and the replica's crashpoints, the replication
stream (`replication`, serve/replicate.py), the pool's lease and
heartbeat clocks, the two silent-corruption sites, the supervisor's
device revocation (`device_revoke`, sim/supervisor.py: it revokes
devices of the engine's mesh and the run reshards; on one device there
is nothing to lose, so an event there is counted and logged and changes
nothing) and the disk-space probe.
"""

from __future__ import annotations

import os
import signal
import time

from .plan import FaultPlan

# site name -> fault class. Extend HERE when instrumenting a new path
# (and thread the matching hook through the code).
SITES = {
    # durable-write sites
    "journal.append": "durable",       # serve/journal.py append fsync
    "checkpoint.write": "durable",     # sim/checkpoint.py atomic replace
    "exec_cache.write": "durable",     # sim/exec_cache.py atomic replace
    # socket sites (client side of the JSON-lines protocol)
    "protocol.send": "socket",
    "protocol.recv": "socket",
    # named process crashpoints
    "server.post-journal-pre-ack": "crashpoint",
    "scheduler.pre-dispatch": "crashpoint",
    "scheduler.post-dispatch": "crashpoint",
    "scheduler.post-checkpoint": "crashpoint",
    "coordinator.post-lease": "crashpoint",
    "coordinator.post-ack": "crashpoint",
    "worker.pre-ack": "crashpoint",
    "worker.post-checkpoint": "crashpoint",
    # clock-skew sites on the lease/heartbeat timers
    "coordinator.clock": "clock",
    "worker.heartbeat.interval": "clock",
    # replication stream (primary -> replica orders; serve/replicate.py)
    "replicate.send": "replication",
    "replica.pre-fsync-ack": "crashpoint",
    # silent-data-corruption sites (DESIGN.md §24): perturb committed
    # values in place with NO crash; only attestation cross-checks tell
    "fleet.counters": "silent_corruption",      # sim/fleet.py post-drain
    "checkpoint.payload": "silent_corruption",  # element checkpoint arrays
    # capacity loss: a device revoked under a live run, and a filesystem
    # that stops taking bytes for a while
    "devices.revoke": "capacity_loss",  # sim/supervisor.py chunk boundary
    "disk.preflight": "capacity_loss",  # util/diskpressure.py space gate
}

ENV_PLAN = "PRIMETPU_CHAOS_PLAN"  # path to a FaultPlan JSON file
ENV_MODE = "PRIMETPU_CHAOS_MODE"  # "kill" (default) or "raise"


class ChaosCrash(BaseException):
    """Injected process death. BaseException so the `except Exception`
    protocol boundaries in server/coordinator/worker cannot absorb it —
    an injected kill must behave like kill -9, not like a bad request."""


class ChaosRuntime:
    def __init__(self, plan: FaultPlan, mode: str = "raise", obs=None,
                 crash_exc=None):
        if mode not in ("raise", "kill"):
            raise ValueError(f"chaos mode must be raise|kill, got {mode!r}")
        self.plan = plan
        self.mode = mode
        self.obs = obs
        # optional exception factory overriding ChaosCrash — the worker's
        # simulate_crash=True compatibility path raises SimulatedCrash
        self.crash_exc = crash_exc
        self.counts: dict[str, int] = {}   # site -> arrivals this trial
        self.fired: set[int] = set()       # plan event indices consumed
        self.injected: list[dict] = []     # flight log for reports/tests
        self.clock_offsets: dict[str, float] = {}
        # site -> remaining arrivals inside an open sustained window
        # (enospc_window: the fault persists across several probes
        # instead of firing once, like a disk that stays full)
        self.windows: dict[str, int] = {}

    def hit(self, site: str):
        """Count one arrival at `site`; return the matching un-fired
        plan event (marking it fired and logging it), or None."""
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        for i, ev in enumerate(self.plan.events):
            if i in self.fired:
                continue
            if ev.site == site and ev.occurrence == n:
                self.fired.add(i)
                self.injected.append(
                    {"site": site, "occurrence": n, "action": ev.action}
                )
                if self.obs is not None:
                    self.obs.chaos_event(site, ev.action, occurrence=n)
                return ev
        return None

    def crash(self, site: str, action: str):
        if self.mode == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if self.crash_exc is not None:
            raise self.crash_exc(site)
        raise ChaosCrash(f"{site}: injected {action}")


_RT: ChaosRuntime | None = None


def install(plan: FaultPlan, mode: str = "raise", obs=None,
            crash_exc=None) -> ChaosRuntime:
    global _RT
    _RT = ChaosRuntime(plan, mode=mode, obs=obs, crash_exc=crash_exc)
    return _RT


def deactivate() -> None:
    global _RT
    _RT = None


def runtime() -> ChaosRuntime | None:
    return _RT


class active:
    """Context manager for trial code: install on enter, ALWAYS
    deactivate on exit (including ChaosCrash unwinds)."""

    def __init__(self, plan: FaultPlan, mode: str = "raise", obs=None):
        self.plan = plan
        self.mode = mode
        self.obs = obs
        self.rt: ChaosRuntime | None = None

    def __enter__(self) -> ChaosRuntime:
        self.rt = install(self.plan, mode=self.mode, obs=self.obs)
        return self.rt

    def __exit__(self, *exc):
        deactivate()
        return False


def install_from_env() -> ChaosRuntime | None:
    """Subprocess activation: when PRIMETPU_CHAOS_PLAN names a plan
    file, install it (default mode `kill` — a subprocess under chaos
    dies for real). Called once from the CLI entry point, so spawned
    workers/coordinators inherit the campaign's plan through the
    environment. No-op when the var is unset or a runtime exists."""
    path = os.environ.get(ENV_PLAN)
    if not path or _RT is not None:
        return _RT
    return install(FaultPlan.load(path),
                   mode=os.environ.get(ENV_MODE, "kill"))


# ---- the hooks (each begins with the no-plan fast path) ------------------


def crashpoint(site: str) -> None:
    """Named process crashpoint: die here when the plan says so."""
    if _RT is None:
        return
    ev = _RT.hit(site)
    if ev is not None:
        _RT.crash(site, ev.action)


def durable(site: str, f=None, data=None, path=None) -> None:
    """Durable-write site, called BEFORE the real write/replace.

    `f`+`data` describe an imminent append (journal): `torn` writes a
    plan-chosen prefix of `data` — flushed but never fsynced — and then
    crashes, leaving exactly the torn tail a power cut leaves.
    `path` describes a finished temp file awaiting its atomic rename
    (checkpoint): `torn` truncates the temp file and crashes BEFORE the
    rename, so the destination must still hold the previous complete
    snapshot. `fsync_fail`/`enospc` crash with nothing written at all —
    on a live OS, bytes that never reached a successful fsync must be
    assumed lost, and modeling that as "the append never happened" is
    the conservative corner. `delay` just stalls the caller."""
    if _RT is None:
        return
    ev = _RT.hit(site)
    if ev is None:
        return
    if ev.action == "delay":
        time.sleep(float(ev.arg("s", 0.005)))
        return
    if ev.action == "torn":
        frac = float(ev.arg("frac", 0.5))
        if f is not None and data is not None and len(data):
            cut = max(1, min(len(data) - 1, int(len(data) * frac)))
            f.write(data[:cut])
            f.flush()
        elif path is not None:
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(max(1, int(size * frac)))
    _RT.crash(site, ev.action)


def socket_send(site: str, sock, payload: bytes) -> bool:
    """Socket-send site. Returns True when the fault consumed the send
    (the caller must NOT sendall); False to proceed normally.

    `short_send` delivers a partial frame then drops the connection —
    the peer sees a torn frame, the caller sees a post-send
    ConnectionError and cannot know whether the request landed (the
    lost-ACK scenario idempotency tokens exist for). `disconnect` drops
    the connection before any byte. `duplicate` delivers the frame
    twice — the peer must dedup. `delay` stalls then sends normally."""
    if _RT is None:
        return False
    ev = _RT.hit(site)
    if ev is None:
        return False
    if ev.action == "delay":
        time.sleep(float(ev.arg("s", 0.005)))
        return False
    if ev.action == "duplicate":
        sock.sendall(payload)
        sock.sendall(payload)
        return True
    if ev.action == "short_send":
        frac = float(ev.arg("frac", 0.5))
        cut = max(1, min(len(payload) - 1, int(len(payload) * frac)))
        try:
            sock.sendall(payload[:cut])
        finally:
            sock.close()
        raise ConnectionError(f"{site}: injected short send + disconnect")
    # disconnect
    sock.close()
    raise ConnectionError(f"{site}: injected disconnect")


def socket_recv(site: str, sock) -> None:
    """Socket-recv site, called after send / before the reply read.
    `disconnect` drops the connection so the reply — and any ACK it
    carried — is lost after the request may already have been handled."""
    if _RT is None:
        return
    ev = _RT.hit(site)
    if ev is None:
        return
    if ev.action == "delay":
        time.sleep(float(ev.arg("s", 0.005)))
        return
    sock.close()
    raise ConnectionError(f"{site}: injected disconnect before reply")


def clock_skew(site: str, value: float) -> float:
    """Clock/interval site: pass `value` through, skewed once the plan's
    event has fired (the offset persists for the rest of the trial —
    clocks jump, they don't flicker)."""
    if _RT is None:
        return value
    ev = _RT.hit(site)
    if ev is not None and ev.action == "skew":
        _RT.clock_offsets[site] = (
            _RT.clock_offsets.get(site, 0.0) + float(ev.arg("offset_s", 1.0))
        )
    return value + _RT.clock_offsets.get(site, 0.0)


def replication(site: str):
    """Replication-stream site (primary side, before the order goes on
    the wire). `delay` stalls in place and is consumed here; `partition`
    and `duplicate` return the event for the ReplicaLink to enact — a
    partition must close the link AND suppress reconnection for its
    window, which only the link's own state can express."""
    if _RT is None:
        return None
    ev = _RT.hit(site)
    if ev is None:
        return None
    if ev.action == "delay":
        time.sleep(float(ev.arg("s", 0.005)))
        return None
    return ev


def corrupt(site: str, arrays: dict) -> bool:
    """Silent-corruption site (DESIGN.md §24): perturb one committed
    int64 value in one of `arrays` (a dict of writable host numpy
    arrays), in place, with NO crash and NO error — the caller proceeds
    to fingerprint, checkpoint and ACK the wrong data exactly like a
    machine with a flaky DIMM would. Detection is attestation's job
    (invariant F), not this hook's. Returns True when a flip fired."""
    if _RT is None:
        return False
    ev = _RT.hit(site)
    if ev is None or ev.action != "flip" or not arrays:
        return False
    keys = sorted(arrays)
    arr = arrays[keys[int(ev.arg("key", 0)) % len(keys)]]
    flat = arr.reshape(-1)
    delta = int(ev.arg("delta", 1)) or 1
    flat[int(ev.arg("pos", 0)) % flat.size] += delta
    return True


def disk_full(site: str) -> bool:
    """Sustained-ENOSPC site: True while a plan-opened window is live.

    Unlike `durable`'s one-shot `enospc` (which models a crash), an
    `enospc_window` event opens a window of `calls` consecutive arrivals
    during which the probe reports a full disk and then heals — the shape
    real disk pressure takes, and the one the diskpressure retry ladder
    is built to ride out without losing ACKed state."""
    if _RT is None:
        return False
    ev = _RT.hit(site)
    if ev is not None and ev.action == "enospc_window":
        _RT.windows[site] = (
            _RT.windows.get(site, 0) + max(1, int(ev.arg("calls", 3)))
        )
    left = _RT.windows.get(site, 0)
    if left > 0:
        _RT.windows[site] = left - 1
        return True
    return False


def wrap_clock(site: str, clock):
    """Wrap a clock callable with the skew site. Returns `clock`
    UNCHANGED when no runtime is active at wrap time — the no-plan path
    keeps the exact original callable (zero per-call overhead), which is
    why chaos must be installed before the component is constructed."""
    if _RT is None:
        return clock

    def skewed():
        return clock_skew(site, clock())

    return skewed


def device_revoke(site: str):
    """Capacity-loss site at a supervised chunk boundary: returns the
    plan's `revoke` event (whose `n` arg says how many devices vanish) or
    None. The caller, the supervisor, enacts it, because only it knows
    which devices its engine holds."""
    if _RT is None:
        return None
    ev = _RT.hit(site)
    if ev is not None and ev.action == "revoke":
        return ev
    return None
