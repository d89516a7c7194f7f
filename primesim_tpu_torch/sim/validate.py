"""Machine-invariant checks on the port's state (host side, numpy).

A copy of the JAX package's `sim/validate.py` that reads the port's torch
state: every field goes through `_np` (a host copy), so the checks run on
a state that lies on the card as well. `effective_l1_state` re-derives each
L1 way's directory-validated MESI state, as the engine's phase 1 does.
"""

from __future__ import annotations

import numpy as np

from ..config.machine import MachineConfig
from .state import E, I, S, llc_meta_width


def _np(x) -> np.ndarray:
    """A host numpy copy of a torch tensor (or an array-like)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def engine_l1_to_golden(cfg: MachineConfig, arr: np.ndarray) -> np.ndarray:
    """Reshape an engine L1 plane [C, W1*S1] to golden layout [C, S1, W1]."""
    C = arr.shape[0]
    W1, S1 = cfg.l1.ways, cfg.l1.sets
    return np.transpose(arr.reshape(C, W1, S1), (0, 2, 1))


def l1_views(cfg: MachineConfig, state):
    """Split the engine's fused L1 array into its four planes.

    Returns (tag, state, lru, ptr), each [C, W1*S1] (engine way-major
    column layout; feed through `engine_l1_to_golden` for the golden's
    [C, S1, W1] layout).
    """
    arr = _np(state.l1)
    FS = cfg.l1.ways * cfg.l1.sets
    return (
        arr[:, :FS],
        arr[:, FS : 2 * FS],
        arr[:, 2 * FS : 3 * FS],
        arr[:, 3 * FS : 4 * FS],
    )


def epoch_views(cfg: MachineConfig, state):
    """The invalidation-epoch planes (coarse-vector validation inputs):
    (l1_eph [C, W1*S1], llc_eph [B, S2, W2])."""
    FS = cfg.l1.ways * cfg.l1.sets
    W2, S2, B = cfg.llc.ways, cfg.llc.sets, cfg.n_banks
    l1_eph = _np(state.l1)[:, 4 * FS : 5 * FS]
    llc_eph = _np(state.dirm)[:, 3 * W2 : 4 * W2].reshape(
        B, S2, W2
    )
    return l1_eph, llc_eph


def sharers_view(cfg: MachineConfig, state):
    """The packed sharer words [B*S2, W2*NW] from the fused `dirm` rows,
    reinterpreted as uint32 (engine stores them as int32 bit patterns;
    the golden model uses uint32)."""
    MW = llc_meta_width(cfg)
    return _np(state.dirm)[:, MW:].view(np.uint32)


def llc_views(cfg: MachineConfig, state):
    """Unpack the engine's fused LLC metadata into golden-layout views.

    The engine stores the whole per-(bank,set) LLC metadata in one
    `dirm` row (row slot = bank*S2 + set; columns [2w]=tag,
    [2w+1]=owner, [2*W2+w]=lru); returns (llc_tag, llc_owner, llc_lru)
    as [B, S2, W2] NumPy arrays, the golden model's layout.
    """
    B = cfg.n_banks
    S2, W2 = cfg.llc.sets, cfg.llc.ways
    meta = _np(state.dirm)
    pairs = meta[:, : 2 * W2].reshape(B, S2, W2, 2)
    lru = meta[:, 2 * W2 : 3 * W2].reshape(B, S2, W2)
    return pairs[..., 0], pairs[..., 1], lru


def effective_l1_state(
    cfg: MachineConfig,
    l1_tag: np.ndarray,  # [C, W1*S1] (engine layout, way-major columns)
    l1_state: np.ndarray,  # [C, W1*S1] locally-written MESI
    llc_tag: np.ndarray,  # [B, S2, W2]
    llc_owner: np.ndarray,  # [B, S2, W2]
    sharers: np.ndarray,  # [B*S2, W2*NW] packed rows (engine layout)
    l1_eph: np.ndarray | None = None,  # [C, W1*S1] fill epochs (coarse)
    llc_eph: np.ndarray | None = None,  # [B, S2, W2] entry epochs (coarse)
) -> np.ndarray:
    """Directory-validated MESI state per L1 way (engine phase-1 rule).

    Accepts the engine's flattened way-major L1 layout and returns the
    validated states in the golden model's [C, S1, W1] layout.
    """
    l1_tag = engine_l1_to_golden(cfg, l1_tag)
    l1_state = engine_l1_to_golden(cfg, l1_state)
    C, S1, W1 = l1_tag.shape
    B, S2, W2 = llc_tag.shape
    NW = cfg.n_sharer_words
    logB = B.bit_length() - 1

    ltag2 = llc_tag.reshape(B * S2, W2)
    lown2 = llc_owner.reshape(B * S2, W2)
    sh3 = sharers.reshape(B * S2, W2, NW)
    logG = cfg.sharer_group.bit_length() - 1

    slot = (l1_tag & (B - 1)) * S2 + ((l1_tag >> logB) & (S2 - 1))  # [C,S1,W1]
    tags = ltag2[slot]  # [C,S1,W1,W2]
    match = tags == l1_tag[..., None]
    has = match.any(-1)
    hway = match.argmax(-1)
    owner = np.take_along_axis(lown2[slot], hway[..., None], -1)[..., 0]
    cores = np.arange(C, dtype=np.int64)[:, None, None]
    gbit = cores >> logG  # sharer-GROUP bit index (identity at G=1)
    word = np.take_along_axis(
        sh3[slot],  # [C,S1,W1,W2,NW]
        np.broadcast_to((gbit >> 5), slot.shape)[..., None, None],
        -1,
    )[..., 0]  # [C,S1,W1,W2]
    shword = np.take_along_axis(word, hway[..., None], -1)[..., 0]
    shbit = ((shword >> (gbit & 31).astype(np.uint32)) & 1) != 0
    if cfg.sharer_group > 1:
        # coarse vector: the group bit only validates an entry filled at
        # the directory entry's CURRENT invalidation epoch (engine.py
        # `_validate_ways` — a neighbor's re-share must not resurrect an
        # invalidated copy)
        if l1_eph is None or llc_eph is None:
            raise ValueError(
                "sharer_group > 1 requires l1_eph/llc_eph for validation"
            )
        l1_eph = engine_l1_to_golden(cfg, l1_eph)
        eph2 = llc_eph.reshape(B * S2, W2)
        veph = np.take_along_axis(eph2[slot], hway[..., None], -1)[..., 0]
        shbit = shbit & (veph == l1_eph)

    return np.where(
        (l1_state == I) | ~has,
        I,
        np.where(owner == cores, l1_state, np.where(shbit, S, I)),
    ).astype(l1_state.dtype)


def check_invariants(cfg: MachineConfig, state, done_mask=None) -> None:
    """DESIGN.md §5 debug invariants, checked host-side on a MachineState.

    Raises AssertionError naming the violated invariant
    (`Engine.verify_invariants`).

    `done_mask` ([C] bool) marks finished cores: their epoch-relative
    clocks legitimately go negative once rebases (which track only LIVE
    cores) outrun them — the true clock is `cycles + cycle_base`. Without
    the mask the clock invariant is skipped.
    """
    def _require(cond, msg):
        if not cond:
            raise AssertionError(msg)

    C = cfg.n_cores
    l1_tag, l1_state, _, _ = l1_views(cfg, state)
    llc_tag, llc_owner, _ = llc_views(cfg, state)
    sharers = sharers_view(cfg, state)
    B, S2, W2 = llc_tag.shape
    NW = cfg.n_sharer_words

    # 1. directory exclusivity (MESI): an owned entry records no sharers.
    # Under MOESI dirty sharing is the Owned state's point, so it weakens
    # to: an owned entry with sharers records the owner's own bit.
    sh3 = sharers.reshape(B * S2, W2, NW)
    owned = (llc_owner >= 0).reshape(B * S2, W2)
    if cfg.coherence == "moesi":
        own2 = np.clip(llc_owner.reshape(B * S2, W2), 0, C - 1)
        oword = np.take_along_axis(sh3, (own2 >> 5)[..., None], -1)[..., 0]
        obit = (oword >> (own2 & 31).astype(np.uint32)) & 1
        _require(
            not (owned & (sh3 != 0).any(-1) & (obit == 0)).any(),
            "invariant: moesi owned entry has sharers but no owner bit",
        )
    else:
        _require(
            not (owned & (sh3 != 0).any(-1)).any(),
            "invariant: owned LLC entry has non-empty sharer set",
        )

    # 2. owner / sharer-bit ranges
    _require(
        ((llc_owner >= -1) & (llc_owner < C)).all(),
        "invariant: llc_owner out of range",
    )
    n_grp = cfg.n_sharer_groups
    if n_grp % 32:
        bits = (
            (sh3[..., None] >> np.arange(32, dtype=np.uint32)) & 1
        ).reshape(B * S2, W2, NW * 32)
        _require(
            not (bits[:, :, n_grp:] != 0).any(),
            "invariant: sharer bits set beyond the group count",
        )

    # 3. valid LLC tags unique per (bank, set)
    t2 = llc_tag.reshape(B * S2, W2)
    for w in range(W2):
        for w2 in range(w + 1, W2):
            clash = (t2[:, w] != -1) & (t2[:, w] == t2[:, w2])
            _require(not clash.any(), "invariant: duplicate valid LLC tag in set")

    # 4. valid L1 tags unique per (core, set) — the fill path clears stale
    # duplicates so a line never occupies two ways
    gt = engine_l1_to_golden(cfg, l1_tag)  # [C, S1, W1]
    W1 = gt.shape[2]
    for w in range(W1):
        for w2 in range(w + 1, W1):
            clash = (gt[:, :, w] != -1) & (gt[:, :, w] == gt[:, :, w2])
            _require(not clash.any(), "invariant: duplicate valid L1 tag in set")

    # 5. effective E/M exclusivity: at most one core holds a line in E/M
    l1_eph, llc_eph = (
        epoch_views(cfg, state) if cfg.sharer_group > 1 else (None, None)
    )
    eff = effective_l1_state(
        cfg, l1_tag, l1_state, llc_tag, llc_owner, sharers,
        l1_eph=l1_eph, llc_eph=llc_eph,
    )
    em = eff >= E
    em_lines = gt[em]
    _require(
        len(np.unique(em_lines)) == len(em_lines),
        "invariant: two cores hold the same line in E/M",
    )

    # 6. synchronization tables
    lock_holder = _np(state.lock_holder)
    barrier_count = _np(state.barrier_count)
    barrier_time = _np(state.barrier_time)
    sync_flag = _np(state.sync_flag)
    _require(
        ((lock_holder >= -1) & (lock_holder < C)).all(),
        "invariant: lock_holder out of range",
    )
    _require((barrier_count >= 0).all(), "invariant: negative barrier count")
    _require(
        (barrier_time[barrier_count == 0] == 0).all(),
        "invariant: stale barrier_time on empty slot",
    )
    _require(np.isin(sync_flag, (0, 1)).all(), "invariant: sync_flag not 0/1")

    # 7. core bookkeeping
    ptr = _np(state.ptr)
    _require((ptr >= 0).all(), "invariant: negative trace pointer")
    if done_mask is not None:
        live = ~np.asarray(done_mask)
        _require(
            (_np(state.cycles)[live] >= 0).all(),
            "invariant: negative (under-rebased) live core clock",
        )


def check_chunk_invariants(
    cfg: MachineConfig,
    state,
    done_mask=None,
    live_mask=None,
    prev_totals: dict | None = None,
    totals: dict | None = None,
) -> None:
    """Post-chunk guard (`RunSupervisor`, `--guard=warn|fail`): the full
    MESI/directory consistency suite plus two cross-chunk checks that
    only make sense at a committed cut.

    - clock-window: the slowest LIVE core (not at END, not frozen at a
      barrier, not fail-stopped — `live_mask`, see Engine.live_mask)
      stays within one quantum of `quantum_end`. The golden model asserts this every
      step; here it is the cheap host-side witness that the engine's
      quantum arbitration hasn't drifted.
    - monotone counters: 64-bit host accumulator totals never decrease
      between chunks (`prev_totals`/`totals`, name -> int) — a decrease
      means a drain carry was lost or applied twice.

    Raises AssertionError naming the violated invariant, like
    check_invariants; the supervisor maps that to warn/fail. `state=None`
    skips the state checks (used for the fleet's aggregate counter-total
    check, where per-element states were already checked individually).
    """
    if state is not None:
        check_invariants(cfg, state, done_mask=done_mask)
    if state is not None and live_mask is not None:
        live = np.asarray(live_mask)
        if live.any():
            qe = int(_np(state.quantum_end))
            lo = int(_np(state.cycles)[live].min())
            if qe - lo > cfg.quantum:
                raise AssertionError(
                    f"invariant: cycle skew {qe - lo} exceeds quantum "
                    f"{cfg.quantum} (quantum_end={qe}, slowest live core "
                    f"at {lo})"
                )
    if prev_totals is not None and totals is not None:
        for k, v in totals.items():
            pv = prev_totals.get(k, 0)
            if v < pv:
                raise AssertionError(
                    f"invariant: counter {k!r} decreased ({pv} -> {v})"
                )
