"""The invalidation / back-invalidation reductions.

`sharer_reductions` replaces the JAX package's Pallas kernel
`kernels/reductions.py::sharer_reductions`: on CUDA tensors it launches
`csrc/sharer_reductions.cu` (one warp per core, over the set bits of the
row's sharer words) and nothing else: the flags `inv_row`/`vic_valid` are
read as the bytes of bool tensors and `vic_owner` through its stride. On
CPU tensors it runs the plain version below, the same function written
as dense torch ops over [C, 32*NW] target bits. Full-map directory and
mesh topology only (the port's `check_port_supported`).
"""

from __future__ import annotations

import torch

from ..config.machine import MachineConfig
from ..noc import topology
from . import build
from .layouts import check_tensor


def sharer_reductions_plain(
    cfg: MachineConfig, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
    cid, link_lat, router_lat,
):
    """Plain torch version: returns (inv_lat, inv_count, inv_hops,
    back_count, back_hops), each [C] int32."""
    C = shw.shape[0]
    NW = cfg.n_sharer_words
    mx = cfg.noc.mesh_x
    t = torch.arange(NW * 32, dtype=torch.int32, device=shw.device)[None, :]
    word = (t[0] >> 5).long()
    bits = ((shw[:, word] >> (t & 31)) & 1) != 0  # [C, 32*NW]
    vbits = ((vic_shw[:, word] >> (t & 31)) & 1) != 0
    tvalid = t < C
    tt = t % cfg.n_tiles
    bt = btile[:, None]
    hops = topology.coord_hops(cfg.noc.topology, bt % mx, bt // mx, tt % mx, tt // mx)
    lat2 = 2 * (hops * link_lat + (hops + 1) * router_lat)
    hops2 = 2 * hops
    sh_b = bits & (t != cid[:, None]) & (inv_row[:, None] != 0) & tvalid
    vo = vic_owner[:, None]
    bk_b = (vbits | ((t == vo) & (vo >= 0))) & (vic_valid[:, None] != 0) & tvalid
    i32 = torch.int32
    return (
        torch.where(sh_b, lat2, 0).amax(1).to(i32),
        sh_b.sum(1, dtype=i32),
        torch.where(sh_b, hops2, 0).sum(1, dtype=i32),
        bk_b.sum(1, dtype=i32),
        torch.where(bk_b, hops2, 0).sum(1, dtype=i32),
    )


def sharer_reductions(
    cfg: MachineConfig, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
    cid, link_lat, router_lat,
):
    """The kernel on CUDA tensors, its plain version on CPU tensors.
    `inv_row`/`vic_valid` are bool [C], `vic_owner` int32 [C] of any
    stride, the other lanes contiguous int32 [C]; `link_lat`/`router_lat`
    are 0-d int32 tensors on the same device."""
    dev = shw.device
    if dev.type == "cpu":
        return sharer_reductions_plain(
            cfg, shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid,
            link_lat, router_lat,
        )
    if dev.type != "cuda":
        raise ValueError(f"sharer_reductions: unsupported device {dev}")
    C, NW = cfg.n_cores, cfg.n_sharer_words
    check_tensor("shw", shw, (C, NW), dev)
    check_tensor("vic_shw", vic_shw, (C, NW), dev)
    for name, x in (("btile", btile), ("cid", cid)):
        check_tensor(name, x, (C,), dev)
    for name, x in (("inv_row", inv_row), ("vic_valid", vic_valid)):
        check_tensor(name, x, (C,), dev, torch.bool)  # read as bytes
    if vic_owner.dtype != torch.int32 or vic_owner.shape != (C,) or vic_owner.device != dev:
        raise ValueError(
            f"vic_owner must be int32 [{C}] on {dev}, got {vic_owner.dtype} "
            f"{list(vic_owner.shape)} on {vic_owner.device}"
        )
    for name, x in (("link_lat", link_lat), ("router_lat", router_lat)):
        check_tensor(name, x, (), dev)
    outs = [torch.empty(C, dtype=torch.int32, device=dev) for _ in range(5)]
    build.launch(
        "sharer_reductions",
        [shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid, link_lat,
         router_lat, *outs],
        [C, NW, cfg.n_tiles, cfg.noc.mesh_x, vic_owner.stride(0)],
        torch.cuda.current_stream(dev),
    )
    return tuple(outs)
