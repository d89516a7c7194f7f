"""Per-chunk fingerprint chains over committed simulator state, the JAX
package's `attest/chain.py` for the port.

At every commit point the chunked loop holds everything a verifier needs:
the drained `host_counters`, the rebased `cycle_base`, `steps_run`, and
the `MachineState` itself. A fingerprint is one SHA-256 over those values
in a fixed layout; chaining folds each chunk's fingerprint into a running
head (`head_k = H(head_{k-1} || digest_k)`), so two executions agree on
the final head iff they agreed on every committed chunk. The simulator is
bit-exact across solo, fleet, card and CPU, and across the two packages,
so the chain is a checkable cross-execution invariant: a silently wrong
run produces a different head, not a plausible-looking result.

The digest hashes the same bytes as the JAX package's: the state's
leaves in its `jax.tree_util.tree_leaves` order and dtypes
(`sim/checkpoint.py::_state_arrays`, which also writes them to
checkpoints: the fault state's uint32 values as uint32), brought to the
host in one batched transfer per chunk and hashed in place. The heads of
a run therefore equal the JAX package's heads of the same run at the same
cadence.

Engines hold `self.attest = None` by default and touch nothing then, so
attestation off costs nothing and changes nothing. Chain payloads are
small dicts `{head, chunks, start, chunk_steps}`. Two payloads are
comparable only when `start` and `chunk_steps` agree: a forked run (its
chain starts at the prefix boundary) or an OOM-halved cadence produces a
different but equally valid chain, never a divergence.

`toolchain_fingerprint` names the port's toolchain (`torch`, `cuda`,
`backend`, and `kernels`: the key the kernel builds are made under). A
JAX fingerprint (`jax`, `jaxlib`, `backend`) and a port fingerprint never
match: `toolchain_matches` names the first differing key, so a pool that
mixed the two packages would refuse the other's workers at lease time.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from ..stats.counters import COUNTER_NAMES

# Domain tag: bump if the digest layout ever changes, so heads from
# different layouts can never collide as "equal".
_DOMAIN = b"ptattest1"

GENESIS = ""

_TOOLCHAIN_KEYS = ("torch", "cuda", "backend", "kernels")


def chunk_digest(steps_run: int, cycle_base: int, host_counters: dict,
                 leaves: list, cursor=None) -> str:
    """Fingerprint one committed chunk: counters + state leaves in a
    fixed order. `leaves` are the state's host arrays in leaf order;
    `cursor` joins only for stream engines, whose chain is window-based
    and scoped to the stream run."""
    h = hashlib.sha256(_DOMAIN)
    h.update(np.int64(steps_run).tobytes())
    h.update(np.int64(cycle_base).tobytes())
    if cursor is not None:
        h.update(np.ascontiguousarray(np.asarray(cursor, dtype=np.int64)))
    for name in COUNTER_NAMES:
        h.update(np.ascontiguousarray(np.asarray(host_counters[name], dtype=np.int64)))
    for leaf in leaves:
        # hashed through the buffer protocol: the bytes of .tobytes()
        # without the copy
        h.update(np.ascontiguousarray(leaf))
    return h.hexdigest()


def link(prev_head: str, digest: str) -> str:
    return hashlib.sha256(
        _DOMAIN + prev_head.encode() + digest.encode()).hexdigest()


def comparable(a: dict | None, b: dict | None) -> bool:
    """Two chain payloads can be meaningfully compared only when they
    cover the same steps from the same starting boundary at the same
    chunk cadence."""
    if not a or not b or not a.get("head") or not b.get("head"):
        return False
    return (int(a.get("start", 0)) == int(b.get("start", 0))
            and int(a.get("chunk_steps", 0)) == int(b.get("chunk_steps", 0)))


def heads_equal(a: dict, b: dict) -> bool:
    return (a.get("head") == b.get("head")
            and int(a.get("chunks", -1)) == int(b.get("chunks", -2)))


class AttestChain:
    """One engine's (or fleet element's) running fingerprint chain."""

    __slots__ = ("head", "chunks", "start", "chunk_steps")

    def __init__(self, chunk_steps: int, *, start: int = 0,
                 head: str = GENESIS, chunks: int = 0):
        self.chunk_steps = int(chunk_steps)
        self.start = int(start)
        self.head = str(head)
        self.chunks = int(chunks)

    def update(self, digest: str) -> str:
        self.head = link(self.head, digest)
        self.chunks += 1
        return self.head

    def payload(self) -> dict:
        return {"head": self.head, "chunks": self.chunks,
                "start": self.start, "chunk_steps": self.chunk_steps}

    def snapshot(self) -> tuple:
        return (self.head, self.chunks)

    def restore(self, snap: tuple) -> None:
        self.head, self.chunks = str(snap[0]), int(snap[1])

    @classmethod
    def from_payload(cls, p: dict) -> "AttestChain":
        return cls(p.get("chunk_steps", 0), start=p.get("start", 0),
                   head=p.get("head", GENESIS), chunks=p.get("chunks", 0))

    def note_cadence(self, chunk_steps: int) -> None:
        """The supervisor OOM-halved the chunk cadence mid-run: the chain
        stays internally valid but is no longer comparable to a
        full-cadence execution; recording the new cadence makes
        `comparable()` say so instead of reporting a false mismatch."""
        self.chunk_steps = int(chunk_steps)


def state_leaves(state) -> list:
    """The state's leaves as host numpy arrays in the JAX package's leaf
    order and dtypes, in one transfer (`checkpoint._state_arrays`)."""
    return state_leaves_many([state])


class SoloAttest:
    """Chain holder for a solo (or stream) engine. The engine calls
    `observe(self)` once per committed chunk (a stream: once per
    window), after its drain and rebase."""

    def __init__(self, chunk_steps: int, *, start: int = 0,
                 head: str = GENESIS, chunks: int = 0):
        self.chain = AttestChain(chunk_steps, start=start, head=head,
                                 chunks=chunks)
        # the last observed chunk's state bytes and host seconds spent
        # bringing them over and hashing them
        self.stats = {"bytes": 0, "transfer_s": 0.0, "hash_s": 0.0}

    def observe(self, eng) -> None:
        t0 = time.perf_counter()
        leaves = state_leaves(eng.state)
        t1 = time.perf_counter()
        d = chunk_digest(int(eng.steps_run), int(eng.cycle_base),
                         eng.host_counters, leaves,
                         cursor=getattr(eng, "cursor", None))
        self.chain.update(d)
        self.stats = {"bytes": sum(a.nbytes for a in leaves), "transfer_s": t1 - t0,
                      "hash_s": time.perf_counter() - t1}

    def payload(self) -> dict:
        return self.chain.payload()

    def snapshot(self) -> tuple:
        return self.chain.snapshot()

    def restore(self, snap: tuple) -> None:
        self.chain.restore(snap)

    def seed(self, payload: dict | None, fallback_start: int = 0) -> None:
        """Continue a checkpointed chain, or, for a checkpoint with no
        chain members, start a fresh chain whose coverage begins at the
        checkpoint's step count."""
        if payload and payload.get("head"):
            self.chain = AttestChain.from_payload(payload)
        else:
            self.chain = AttestChain(self.chain.chunk_steps,
                                     start=int(fallback_start))

    def note_cadence(self, chunk_steps: int) -> None:
        self.chain.note_cadence(chunk_steps)


class FleetAttest:
    """Per-element chains for a FleetEngine. Only tracked slots hash, and
    only elements live at chunk start advance their chain: finished
    elements keep stepping in the batch (their `state.step` moves) but
    their chain stops exactly where the solo engine's loop would have
    stopped, which is what makes fleet heads equal solo heads. The tracked
    live elements' rows come to the host in one transfer."""

    def __init__(self):
        self.chains: dict[int, AttestChain] = {}
        # the last observed chunk's state bytes and host seconds spent
        # bringing them over and hashing them
        self.stats = {"bytes": 0, "transfer_s": 0.0, "hash_s": 0.0}

    def track(self, i: int, chunk_steps: int, *, start: int = 0,
              head: str = GENESIS, chunks: int = 0) -> AttestChain:
        ch = AttestChain(chunk_steps, start=start, head=head,
                         chunks=chunks)
        self.chains[int(i)] = ch
        return ch

    def drop(self, i: int) -> None:
        self.chains.pop(int(i), None)

    def chain(self, i: int) -> AttestChain | None:
        return self.chains.get(int(i))

    def payload(self, i: int) -> dict | None:
        ch = self.chains.get(int(i))
        return None if ch is None else ch.payload()

    def observe(self, fleet, live) -> None:
        live = np.asarray(live)
        rows = [i for i in self.chains if bool(live[i])]
        if not rows:
            self.stats = {"bytes": 0, "transfer_s": 0.0, "hash_s": 0.0}
            return
        from ..sim.state import element_state, leaves

        # every tracked live row's leaves in one transfer, then hashed
        # element by element
        t0 = time.perf_counter()
        per = len(leaves(fleet.state))
        flat = state_leaves_many([element_state(fleet.state, i) for i in rows])
        t1 = time.perf_counter()
        for j, i in enumerate(rows):
            counters = {k: fleet.host_counters[k][i] for k in COUNTER_NAMES}
            d = chunk_digest(int(fleet.steps_run[i]), int(fleet.cycle_base[i]),
                             counters, flat[j * per:(j + 1) * per])
            self.chains[i].update(d)
        self.stats = {"bytes": sum(a.nbytes for a in flat), "transfer_s": t1 - t0,
                      "hash_s": time.perf_counter() - t1}

    def snapshot(self) -> dict:
        return {i: ch.snapshot() for i, ch in self.chains.items()}

    def restore(self, snap: dict) -> None:
        for i, s in snap.items():
            ch = self.chains.get(i)
            if ch is not None:
                ch.restore(s)

    def note_cadence(self, chunk_steps: int) -> None:
        for ch in self.chains.values():
            ch.note_cadence(chunk_steps)


def state_leaves_many(states) -> list:
    """`state_leaves` of several states, concatenated, in one transfer."""
    from ..sim.checkpoint import _state_arrays_many

    return [a for arrs in _state_arrays_many(states) for a in arrs.values()]


def toolchain_fingerprint() -> dict:
    """The toolchain fields a lease grant verifies before letting a
    worker compute anything: torch's and CUDA's versions, the backend,
    and the key the kernels are built under."""
    import torch

    from ..kernels.build import source_key

    return {
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda or "none"),
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "kernels": source_key(),
    }


def toolchain_matches(ours: dict, theirs: dict) -> str:
    """Return '' when compatible, else the first mismatched field."""
    for k in _TOOLCHAIN_KEYS:
        if str(theirs.get(k, "")) != str(ours.get(k, "")):
            return k
    return ""
