"""Sort-based segmented FIFO ranking: the rank primitive that the router
and DRAM-queue contention models share (DESIGN.md §13).

The port's copy of the JAX package's `ops/ranking.py`. Per same-step
transaction i and per FIFO segment s it enters (a directed NoC link or a
DRAM bank controller) both models need

    rank[i, s] = #{ j : key[j] < key[i],  lane j enters segment s },

the number of packets ahead of lane i in s's FIFO, ordered by the
phase-2 arbitration key. The JAX package runs these ops in XLA, outside
any Pallas kernel; here they are plain torch ops (`torch.sort`,
`torch.searchsorted`, `torch.cummax`, `index_add_`), and none of them
synchronises with the host.

The counts do not depend on how a sort orders ties: `lane_order` maps
each key to ``ord[i] = #{j : key[j] < key[i]}``, which collapses ties, so
``key[j] < key[i]`` exactly when ``ord[j] < ord[i]``; and every rank
below counts strictly smaller packed values. Any sort that gives those
counts is exact, and torch's stable sort does.

Batched, every function takes leading element axes: the keys [B, C],
the segments [B, C, S], and each element's lanes sort, count and rank
only among themselves (sorts and scans run along the last axis, one row
per element), so ties and first occurrences stay as in a solo run.

Contract: one entry per (lane, segment). Masked entries carry the
segment ``n_seg``; their ranks are garbage that callers discard, but
every index taken on the way stays in range.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
_i32 = torch.int32


def lane_order(key: torch.Tensor) -> torch.Tensor:
    """Dense first-occurrence rank of each lane's key within its element,
    ``ord[i] = #{j : key[j] < key[i]}``: [..., C] int32 in [0, C). One
    sort of each element's C keys, then each tie group inherits its start
    (a cummax)."""
    C = key.shape[-1]
    pos = torch.arange(C, dtype=_i32, device=key.device)
    sk, sl = torch.sort(key.to(_i32), dim=-1, stable=True)
    grp_start = torch.ones(sk.shape, dtype=torch.bool, device=key.device)
    grp_start[..., 1:] = sk[..., 1:] != sk[..., :-1]
    gstart = torch.where(grp_start, pos, 0).cummax(-1).values
    return torch.empty_like(gstart).scatter_(-1, sl, gstart)


def _segment_starts(seg_flat: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Exclusive per-segment start offsets of each element,
    start[..., s] = #entries with a segment id below s ([..., n_seg + 1]):
    a histogram and its exclusive cumsum."""
    h = torch.zeros((*seg_flat.shape[:-1], n_seg + 1), dtype=_i32, device=seg_flat.device)
    h.scatter_add_(-1, seg_flat.long(), torch.ones_like(seg_flat))
    return h.cumsum(-1, dtype=_i32) - h


def segmented_rank(seg, key=None, n_seg=None, *, order=None, method="auto"):
    """Same-step FIFO ranks: [..., C, S] int32 from seg [..., C, S] int32
    (segment ids in [0, n_seg], ``n_seg`` marking a masked slot) and
    either the lanes' keys [..., C] or ``order=lane_order(key)``, shared
    by the router and DRAM blocks.

    method="packed" sorts ``seg·C + ord`` as one int32 key, which needs
    (n_seg + 1)·C to fit in int32 (true for every shipped geometry); it
    then takes the first position of each value in the sorted list minus
    its segment's start. "lex" sorts by the two keys (segment, ord) and
    takes each tie group's start minus its segment's start; "auto" takes
    "packed" when it fits. Either way each element sorts its own row.
    """
    if n_seg is None:
        raise TypeError("segmented_rank: n_seg is required")
    C, S = seg.shape[-2:]
    lead = seg.shape[:-2]
    if order is None:
        order = lane_order(key)
    seg = seg.to(_i32)
    seg_flat = seg.reshape(*lead, C * S)
    if method == "auto":
        method = "packed" if (n_seg + 1) * C <= INT32_MAX else "lex"
    if method == "packed":
        packed = (seg * C + order[..., None]).reshape(*lead, C * S)
        sp = torch.sort(packed, dim=-1).values
        first = torch.searchsorted(sp, packed, side="left", out_int32=True)
        start = _segment_starts(seg_flat, n_seg)
        return (first - start.gather(-1, seg_flat.clamp(0, n_seg).long())).reshape(seg.shape)
    if method == "lex":
        E = C * S
        dev = seg.device
        pos = torch.arange(E, dtype=_i32, device=dev)
        ord_flat = order[..., None].expand(seg.shape).reshape(*lead, E)
        # lexicographic (segment, ord): a stable sort by the minor key,
        # then a stable sort by the major key
        by_ord = torch.sort(ord_flat, dim=-1, stable=True).indices
        sidx = by_ord.gather(
            -1, torch.sort(seg_flat.gather(-1, by_ord), dim=-1, stable=True).indices
        )
        sseg, sord = seg_flat.gather(-1, sidx), ord_flat.gather(-1, sidx)
        seg_start = torch.ones(sseg.shape, dtype=torch.bool, device=dev)
        seg_start[..., 1:] = sseg[..., 1:] != sseg[..., :-1]
        grp_start = seg_start.clone()
        grp_start[..., 1:] |= sord[..., 1:] != sord[..., :-1]
        seg0 = torch.where(seg_start, pos, 0).cummax(-1).values
        grp0 = torch.where(grp_start, pos, 0).cummax(-1).values
        out = torch.empty(sseg.shape, dtype=_i32, device=dev)
        return out.scatter_(-1, sidx, grp0 - seg0).reshape(seg.shape)
    raise ValueError(f"segmented_rank: unknown method {method!r}")
