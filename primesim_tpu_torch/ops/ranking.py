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

Contract: one entry per (lane, segment). Masked entries carry the
segment ``n_seg``; their ranks are garbage that callers discard, but
every index taken on the way stays in range.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
_i32 = torch.int32


def lane_order(key: torch.Tensor) -> torch.Tensor:
    """Dense first-occurrence rank of each lane's key,
    ``ord[i] = #{j : key[j] < key[i]}``: [C] int32 in [0, C). One sort of
    the C keys, then each tie group inherits its start (a cummax)."""
    C = key.shape[0]
    pos = torch.arange(C, dtype=_i32, device=key.device)
    sk, sl = torch.sort(key.to(_i32), stable=True)
    grp_start = torch.ones(C, dtype=torch.bool, device=key.device)
    grp_start[1:] = sk[1:] != sk[:-1]
    gstart = torch.where(grp_start, pos, 0).cummax(0).values
    return torch.empty_like(gstart).index_put_((sl,), gstart)


def _segment_starts(seg_flat: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Exclusive per-segment start offsets, start[s] = #entries with a
    segment id below s ([n_seg + 1]): a histogram and its exclusive
    cumsum."""
    h = torch.zeros(n_seg + 1, dtype=_i32, device=seg_flat.device)
    h.index_add_(0, seg_flat.long(), torch.ones_like(seg_flat))
    return h.cumsum(0, dtype=_i32) - h


def segmented_rank(seg, key=None, n_seg=None, *, order=None, method="auto"):
    """Same-step FIFO ranks: [C, S] int32 from seg [C, S] int32 (segment
    ids in [0, n_seg], ``n_seg`` marking a masked slot) and either the
    lanes' keys [C] or ``order=lane_order(key)``, shared by the router
    and DRAM blocks.

    method="packed" sorts ``seg·C + ord`` as one int32 key, which needs
    (n_seg + 1)·C to fit in int32 (true for every shipped geometry); it
    then takes the first position of each value in the sorted list minus
    its segment's start. "lex" sorts by the two keys (segment, ord) and
    takes each tie group's start minus its segment's start; "auto" takes
    "packed" when it fits.
    """
    if n_seg is None:
        raise TypeError("segmented_rank: n_seg is required")
    C, S = seg.shape
    if order is None:
        order = lane_order(key)
    seg = seg.to(_i32)
    seg_flat = seg.reshape(C * S)
    if method == "auto":
        method = "packed" if (n_seg + 1) * C <= INT32_MAX else "lex"
    if method == "packed":
        packed = (seg * C + order[:, None]).reshape(C * S)
        sp = torch.sort(packed).values
        first = torch.searchsorted(sp, packed, side="left", out_int32=True)
        start = _segment_starts(seg_flat, n_seg)
        return (first - start[seg_flat.clamp(0, n_seg).long()]).reshape(C, S)
    if method == "lex":
        E = C * S
        dev = seg.device
        pos = torch.arange(E, dtype=_i32, device=dev)
        ord_flat = order[:, None].expand(C, S).reshape(E)
        # lexicographic (segment, ord): a stable sort by the minor key,
        # then a stable sort by the major key
        by_ord = torch.sort(ord_flat, stable=True).indices
        sidx = by_ord[torch.sort(seg_flat[by_ord], stable=True).indices]
        sseg, sord = seg_flat[sidx], ord_flat[sidx]
        seg_start = torch.ones(E, dtype=torch.bool, device=dev)
        seg_start[1:] = sseg[1:] != sseg[:-1]
        grp_start = seg_start.clone()
        grp_start[1:] |= sord[1:] != sord[:-1]
        seg0 = torch.where(seg_start, pos, 0).cummax(0).values
        grp0 = torch.where(grp_start, pos, 0).cummax(0).values
        out = torch.empty(E, dtype=_i32, device=dev)
        return out.index_put_((sidx,), grp0 - seg0).reshape(C, S)
    raise ValueError(f"segmented_rank: unknown method {method!r}")
