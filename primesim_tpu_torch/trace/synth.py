"""Synthetic workload trace generators.

Stand-ins for the reference's benchmark inputs (SPLASH-2 / PARSEC binaries run
under Pin, SURVEY.md §4). Each generator emits the access *pattern class* of a
benchmark family so cache/coherence/NoC behavior is representative and the
expected statistics are analyzable:

- ``uniform_random``  — uncorrelated loads/stores over a working set
- ``stream``          — sequential streaming (stride = line), low reuse
- ``pointer_chase``   — dependent chain, one hot line at a time per core
- ``false_sharing``   — all cores hammer distinct words of the SAME lines
                        (coherence ping-pong; the MESI stress test)
- ``fft_like``        — phases of private strided work + butterfly exchange
                        with partner cores (SPLASH-2 FFT communication shape)
- ``readers_writer``  — one producer writes a block, all others read it
                        (invalidation broadcast shape)
- ``lock_contention`` — cores hammer a small set of mutexes around short
                        critical sections (pthread_mutex shape; LOCK/UNLOCK)
- ``barrier_phases``  — bulk-synchronous phases of private work separated
                        by global (or subset) barriers (SPLASH-2 phase shape)

All generators are deterministic given ``seed``.
"""

from __future__ import annotations

import numpy as np

from .format import (
    EV_BARRIER,
    EV_INS,
    EV_LD,
    EV_LOCK,
    EV_ST,
    EV_UNLOCK,
    N_FIELDS,
    Trace,
    from_arrays,
    from_event_lists,
)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _interleave(rng, mem_events, ins_per_mem: int):
    """Weave INS batches between memory events (~ins_per_mem each, >=1)."""
    out = []
    for ev in mem_events:
        k = int(rng.integers(1, 2 * ins_per_mem + 1)) if ins_per_mem > 0 else 0
        if k:
            out.append((EV_INS, k, 0))
        out.append(ev)
    return out


def uniform_random(
    n_cores: int,
    n_mem_ops: int = 256,
    working_set: int = 1 << 20,
    write_frac: float = 0.3,
    ins_per_mem: int = 3,
    shared_frac: float = 0.2,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """Random accesses; a `shared_frac` of them hit a common shared region."""
    rng = _rng(seed)
    shared_base = 0
    shared_size = max(line * 16, working_set // 8)
    per_core = []
    for c in range(n_cores):
        priv_base = (1 + c) * working_set
        n = n_mem_ops
        is_shared = rng.random(n) < shared_frac
        is_write = rng.random(n) < write_frac
        offs = rng.integers(0, working_set, n)
        sh_offs = rng.integers(0, shared_size, n)
        addrs = np.where(is_shared, shared_base + sh_offs, priv_base + offs)
        addrs = (addrs // 4) * 4
        evs = [
            (EV_ST if w else EV_LD, 4, int(a))
            for w, a in zip(is_write, addrs)
        ]
        per_core.append(_interleave(rng, evs, ins_per_mem))
    return from_event_lists(per_core)


def stream(
    n_cores: int,
    n_mem_ops: int = 256,
    ins_per_mem: int = 2,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """Each core streams sequentially through its own region (cold misses)."""
    rng = _rng(seed)
    per_core = []
    for c in range(n_cores):
        base = (1 + c) * (n_mem_ops * line + (1 << 12))
        evs = [(EV_LD, 4, base + i * line) for i in range(n_mem_ops)]
        per_core.append(_interleave(rng, evs, ins_per_mem))
    return from_event_lists(per_core)


def pointer_chase(
    n_cores: int,
    n_mem_ops: int = 256,
    n_nodes: int = 64,
    ins_per_mem: int = 1,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """Dependent-chain loads over a private ring of nodes (latency-bound)."""
    rng = _rng(seed)
    per_core = []
    for c in range(n_cores):
        base = (1 + c) * (n_nodes * line * 4)
        perm = rng.permutation(n_nodes)
        node = 0
        evs = []
        for _ in range(n_mem_ops):
            evs.append((EV_LD, 8, base + int(perm[node]) * line))
            node = (node + 1) % n_nodes
        per_core.append(_interleave(rng, evs, ins_per_mem))
    return from_event_lists(per_core)


def false_sharing(
    n_cores: int,
    n_mem_ops: int = 256,
    n_hot_lines: int = 4,
    ins_per_mem: int = 1,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """All cores read-modify-write distinct words of the same few lines."""
    rng = _rng(seed)
    per_core = []
    for c in range(n_cores):
        evs = []
        word = (c * 4) % line
        for i in range(n_mem_ops // 2):
            ln = int(rng.integers(0, n_hot_lines))
            addr = ln * line + word
            evs.append((EV_LD, 4, addr))
            evs.append((EV_ST, 4, addr))
        per_core.append(_interleave(rng, evs, ins_per_mem))
    return from_event_lists(per_core)


def fft_like(
    n_cores: int,
    n_phases: int = 4,
    points_per_core: int = 64,
    ins_per_mem: int = 4,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """SPLASH-2 FFT shape: local strided compute, then butterfly exchange.

    Phase p: each core loads/stores its own `points_per_core` elements
    (stride grows with phase), then reads the block of its butterfly partner
    (c XOR 2^p) — cross-tile communication whose distance doubles each phase.

    Built with whole-array numpy (thousands of cores take seconds, not
    minutes), byte for byte the JAX package's per-event loop: every core
    and phase draws its INS batch sizes in the same order from one
    generator, and one vectorized draw gives the same numbers as the loop's
    scalar draws.
    """
    rng = _rng(seed)
    block = points_per_core * 8  # 8-byte points
    c = np.arange(n_cores, dtype=np.int64)
    i = np.arange(points_per_core, dtype=np.int64)
    rd = np.arange(0, points_per_core, max(1, line // 8), dtype=np.int64)
    bits = max(1, (n_cores - 1).bit_length())
    addrs = []
    for p in range(n_phases):
        own = (1 + c)[:, None] * (block * 8) + (i * (8 << p)) % block
        partner = (c ^ (1 << (p % bits))) % n_cores
        addrs.append(np.repeat(own, 2, axis=1))  # LD, ST of each point
        addrs.append((1 + partner)[:, None] * (block * 8) + rd * 8)
    n_ev = 2 * points_per_core + len(rd)  # memory events per core and phase
    addr = np.concatenate(addrs, axis=1)  # [C, n_phases * n_ev]
    typ = np.tile(
        np.r_[np.tile([EV_LD, EV_ST], points_per_core), np.full(len(rd), EV_LD)],
        n_phases,
    )
    mem = np.zeros((n_cores, n_phases * n_ev, N_FIELDS), np.int64)
    mem[:, :, 0] = typ
    mem[:, :, 1] = 8
    mem[:, :, 2] = addr
    if ins_per_mem > 0:
        # one INS batch before every memory event, drawn phase by phase,
        # core by core, event by event
        k = rng.integers(1, 2 * ins_per_mem + 1, size=(n_phases, n_cores, n_ev))
        ins = np.zeros_like(mem)
        ins[:, :, 0] = EV_INS
        ins[:, :, 1] = k.transpose(1, 0, 2).reshape(n_cores, -1)
        mem = np.stack([ins, mem], axis=2).reshape(n_cores, -1, N_FIELDS)
    return from_arrays(mem)


def readers_writer(
    n_cores: int,
    n_rounds: int = 8,
    block_lines: int = 8,
    ins_per_mem: int = 2,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """Core 0 writes a shared block; all others read it (each round)."""
    rng = _rng(seed)
    per_core_evs: list[list] = [[] for _ in range(n_cores)]
    for r in range(n_rounds):
        base = r * block_lines * line
        w = [(EV_ST, 4, base + i * line) for i in range(block_lines)]
        per_core_evs[0].extend(_interleave(rng, w, ins_per_mem))
        for c in range(1, n_cores):
            rd = [(EV_LD, 4, base + i * line) for i in range(block_lines)]
            per_core_evs[c].extend(_interleave(rng, rd, ins_per_mem))
    return from_event_lists(per_core_evs)


def lock_contention(
    n_cores: int,
    n_critical: int = 16,
    n_locks: int = 2,
    ins_per_mem: int = 2,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """Cores repeatedly acquire a few shared mutexes, touch the protected
    data (load + store), and release — the pthread_mutex critical-section
    shape the reference captures by interception (SURVEY.md §2 #1)."""
    rng = _rng(seed)
    per_core = []
    for c in range(n_cores):
        evs = []
        for _ in range(n_critical):
            lk = int(rng.integers(0, n_locks))
            mtx = 0x10000 + lk * 4 * line  # mutex addresses, distinct lines
            data = 0x80000 + lk * line  # protected data, one line per lock
            evs.append((EV_LOCK, 0, mtx))
            evs.append((EV_LD, 4, data))
            evs.append((EV_ST, 4, data))
            evs.append((EV_UNLOCK, 0, mtx))
        per_core.append(_interleave(rng, evs, ins_per_mem))
    return from_event_lists(per_core)


def barrier_phases(
    n_cores: int,
    n_phases: int = 4,
    work_per_phase: int = 12,
    ins_per_mem: int = 2,
    subset: bool = False,
    seed: int = 0,
    line: int = 64,
) -> Trace:
    """Bulk-synchronous phases: private strided work, then a barrier.

    Barrier ids alternate over two slots to exercise slot reuse (count
    reset + re-arm). With ``subset=True`` only the first half of the cores
    participate (participant count = n_cores // 2), the rest free-run —
    exercising per-waiter participant counts.
    """
    rng = _rng(seed)
    half = max(1, n_cores // 2)
    per_core: list[list] = [[] for _ in range(n_cores)]
    for p in range(n_phases):
        for c in range(n_cores):
            base = (1 + c) * (1 << 14) + p * work_per_phase * line
            evs = [(EV_LD, 4, base + i * line) for i in range(work_per_phase)]
            evs.append((EV_ST, 4, base))
            w = _interleave(rng, evs, ins_per_mem)
            if subset:
                if c < half:
                    w.append((EV_BARRIER, half, p % 2))
            else:
                w.append((EV_BARRIER, n_cores, p % 2))
            per_core[c].extend(w)
    return from_event_lists(per_core)


GENERATORS = {
    "uniform_random": uniform_random,
    "stream": stream,
    "pointer_chase": pointer_chase,
    "false_sharing": false_sharing,
    "fft_like": fft_like,
    "readers_writer": readers_writer,
    "lock_contention": lock_contention,
    "barrier_phases": barrier_phases,
}
