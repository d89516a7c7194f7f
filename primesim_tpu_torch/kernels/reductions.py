"""The invalidation / back-invalidation reductions.

`sharer_reductions` replaces the JAX package's Pallas kernel
`kernels/reductions.py::sharer_reductions`: on CUDA tensors it launches
`csrc/sharer_reductions.cu` (one warp per core, over the set bits of the
row's sharer words) and nothing else: the flags `inv_row`/`vic_valid` are
read as the bytes of bool tensors and `vic_owner` through its stride. On
CPU tensors it runs the plain version below, the same function written
as dense torch ops over [C, 32*NW] target bits. A chunked full map
(`sharer_chunk_words` > 0) computes the same function, so it takes the
same kernel and plain version.

Under the coarse sharer vector (`sharer_group` > 1) the same kernel runs
a group mode: the JAX engine's group-table reductions (its XLA branch
for that case, `sim/engine.py`), from the static per-(home tile, group)
tables of `group_tables`. Its plain version is a transcription of that
branch in torch. Both modes take the NoC topology's hop count (mesh,
torus or ring: `noc.topology.coord_hops`), in the kernel through the
launch argument `topology` (`TOPOLOGY_CODE`).

The lanes may be a block of the machine's cores (a core shard of a
tile mesh, `parallel/sharding.py`): `cid` then holds the block's global
core ids, and the sharer bits still name every core of the machine.

Batched, one launch serves the B simulations of a fleet: the rows and
lanes are [B, C, ...], and `link_lat`/`router_lat` are [B] (the elements'
own latency knobs); the core ids and the group tables are shared. Solo
shapes are a batch of one.
"""

from __future__ import annotations

import torch

from ..config.machine import MachineConfig
from ..noc import topology
from . import build
from .layouts import check_tensor, squeeze_all, unsqueeze_all

_i32 = torch.int32
TOPOLOGY_CODE = {"mesh": 0, "torus": 1, "ring": 2}  # the kernel's `topology`


def sharer_reductions_plain(
    cfg: MachineConfig, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
    cid, link_lat, router_lat, tables=None,
):
    """Plain torch version: returns (inv_lat, inv_count, inv_hops,
    back_count, back_hops), each [B, C] int32 ([C] for solo inputs).
    Under sharer_group > 1 the group mode, from `tables`."""
    if shw.dim() == 2:
        return squeeze_all(sharer_reductions_plain(
            cfg, *unsqueeze_all(shw, vic_shw, btile, vic_owner, inv_row, vic_valid),
            cid, *unsqueeze_all(link_lat, router_lat), tables,
        ))
    if cfg.sharer_group > 1:
        return _group_reductions_plain(
            cfg, shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid,
            link_lat, router_lat, tables,
        )
    NW = cfg.n_sharer_words
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    t = torch.arange(NW * 32, dtype=torch.int32, device=shw.device)
    word = (t >> 5).long()
    bits = ((shw[..., word] >> (t & 31)) & 1) != 0  # [B, C, 32*NW]
    vbits = ((vic_shw[..., word] >> (t & 31)) & 1) != 0
    tvalid = t < cfg.n_cores  # the targets: every core of the machine
    tt = t % cfg.n_tiles
    bt = btile[..., None]
    hops = topology.coord_hops(
        cfg.noc.topology, bt % mx, bt // mx, tt % mx, tt // mx, mx, my
    )
    lat2 = 2 * (hops * link_lat[:, None, None] + (hops + 1) * router_lat[:, None, None])
    hops2 = 2 * hops
    sh_b = bits & (t != cid[:, None]) & (inv_row[..., None] != 0) & tvalid
    vo = vic_owner[..., None]
    bk_b = (vbits | ((t == vo) & (vo >= 0))) & (vic_valid[..., None] != 0) & tvalid
    i32 = torch.int32
    return (
        torch.where(sh_b, lat2, 0).amax(-1).to(i32),
        sh_b.sum(-1, dtype=i32),
        torch.where(sh_b, hops2, 0).sum(-1, dtype=i32),
        bk_b.sum(-1, dtype=i32),
        torch.where(bk_b, hops2, 0).sum(-1, dtype=i32),
    )


def _group_reductions_plain(
    cfg: MachineConfig, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
    cid, link_lat, router_lat, tables,
):
    """Plain torch version of the coarse-vector reductions, line for line
    the JAX engine's sharer_group > 1 branch: [B, C, n_groups] flags of
    the set group bits reduced against the home tile's rows of `tables` =
    (memb, max2hops, sum2hops)."""
    memb, max2hops, sum2hops = tables
    Bn, C, NW = shw.shape
    n_grp = cfg.n_sharer_groups
    logG = cfg.sharer_group.bit_length() - 1
    bit5 = torch.arange(32, dtype=_i32, device=shw.device)

    def group_bools(words):  # [B, C, NW] -> [B, C, n_grp]
        b = (words[..., None] >> bit5) & 1
        return b.reshape(Bn, C, NW * 32)[..., :n_grp] != 0

    grp, vic_grp = group_bools(shw), group_bools(vic_shw)
    bt = btile.long()
    mh_rows = max2hops[bt]  # [B, C, n_grp]
    ml_rows = 2 * (mh_rows * link_lat[:, None, None]
                   + (mh_rows + 1) * router_lat[:, None, None])
    sumh_rows = sum2hops[bt]
    g_c = cid >> logG
    selfg = torch.arange(n_grp, dtype=_i32, device=shw.device) == g_c[:, None]
    self_rec = (grp & selfg).any(-1)
    inv_lat = torch.where(inv_row, torch.where(grp, ml_rows, 0).amax(-1), 0)
    inv_count = torch.where(
        inv_row,
        torch.where(grp, memb, 0).sum(-1, dtype=_i32) - self_rec.to(_i32),
        0,
    )
    self_hops = topology.hops(cfg, btile, cid % cfg.n_tiles)
    inv_hops = torch.where(
        inv_row,
        torch.where(grp, sumh_rows, 0).sum(-1, dtype=_i32)
        - torch.where(self_rec, 2 * self_hops, 0),
        0,
    )
    owner = vic_owner.clamp(min=0)
    og = owner >> logG
    own_rec = vic_grp.gather(-1, og.long()[..., None])[..., 0] & (vic_owner >= 0)
    own_extra = (vic_owner >= 0) & ~own_rec
    own_hops = topology.hops(cfg, btile, owner % cfg.n_tiles)
    back_count = torch.where(
        vic_valid,
        torch.where(vic_grp, memb, 0).sum(-1, dtype=_i32) + own_extra.to(_i32),
        0,
    )
    back_hops = torch.where(
        vic_valid,
        torch.where(vic_grp, sumh_rows, 0).sum(-1, dtype=_i32)
        + torch.where(own_extra, 2 * own_hops, 0),
        0,
    )
    return tuple(x.to(_i32) for x in (inv_lat, inv_count, inv_hops, back_count, back_hops))


def sharer_reductions(
    cfg: MachineConfig, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
    cid, link_lat, router_lat, tables=None,
):
    """The kernel on CUDA tensors, its plain version on CPU tensors.
    Batched: `shw`/`vic_shw` [B, C, NW], `inv_row`/`vic_valid` bool
    [B, C], `vic_owner` int32 [B, C] of any core stride (its element
    stride C times that), the other lanes contiguous int32 [B, C];
    `link_lat`/`router_lat` are int32 [B] on the same device; `cid` [C] is
    shared. Solo shapes (no B, 0-d latencies) are a batch of one. Under
    `cfg.sharer_group` > 1, `tables` is `group_tables(cfg, device)`: (memb
    [n_groups], max2hops and sum2hops [n_tiles, n_groups]), int32 on the
    device."""
    dev = shw.device
    coarse = cfg.sharer_group > 1
    if coarse and tables is None:
        raise ValueError("sharer_reductions: sharer_group > 1 needs the group tables")
    if dev.type == "cpu":
        return sharer_reductions_plain(
            cfg, shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid,
            link_lat, router_lat, tables,
        )
    if dev.type != "cuda":
        raise ValueError(f"sharer_reductions: unsupported device {dev}")
    if shw.dim() == 2:
        return squeeze_all(sharer_reductions(
            cfg, *unsqueeze_all(shw, vic_shw, btile, vic_owner, inv_row, vic_valid),
            cid, *unsqueeze_all(link_lat, router_lat), tables,
        ))
    Bn, C, NW = shw.shape[0], shw.shape[1], cfg.n_sharer_words
    n_grp = cfg.n_sharer_groups
    check_tensor("shw", shw, (Bn, C, NW), dev)
    check_tensor("vic_shw", vic_shw, (Bn, C, NW), dev)
    check_tensor("btile", btile, (Bn, C), dev)
    check_tensor("cid", cid, (C,), dev)
    for name, x in (("inv_row", inv_row), ("vic_valid", vic_valid)):
        check_tensor(name, x, (Bn, C), dev, torch.bool)  # read as bytes
    if (vic_owner.dtype != torch.int32 or vic_owner.shape != (Bn, C)
            or vic_owner.device != dev
            or (Bn > 1 and vic_owner.stride(0) != C * vic_owner.stride(1))):
        raise ValueError(
            f"vic_owner must be int32 [{Bn}, {C}] on {dev} with element stride "
            f"C * core stride, got {vic_owner.dtype} {list(vic_owner.shape)} "
            f"strides {vic_owner.stride()} on {vic_owner.device}"
        )
    for name, x in (("link_lat", link_lat), ("router_lat", router_lat)):
        check_tensor(name, x, (Bn,), dev)
    if coarse:
        memb, max2hops, sum2hops = tables
        check_tensor("memb", memb, (n_grp,), dev)
        check_tensor("max2hops", max2hops, (cfg.n_tiles, n_grp), dev)
        check_tensor("sum2hops", sum2hops, (cfg.n_tiles, n_grp), dev)
    else:
        memb = max2hops = sum2hops = cid  # never read by the full-map mode
    outs = [torch.empty(Bn, C, dtype=torch.int32, device=dev) for _ in range(5)]
    build.launch(
        "sharer_reductions",
        [shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid, link_lat,
         router_lat, *outs, memb, max2hops, sum2hops],
        [Bn, C, cfg.n_cores, NW, cfg.n_tiles, cfg.noc.mesh_x, cfg.noc.mesh_y,
         TOPOLOGY_CODE[cfg.noc.topology], vic_owner.stride(1),
         cfg.sharer_group.bit_length() - 1, n_grp],
        torch.cuda.current_stream(dev),
    )
    return tuple(outs)
