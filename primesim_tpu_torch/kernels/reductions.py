"""The dense invalidation / back-invalidation reductions.

`sharer_reductions` replaces the JAX package's Pallas kernel
`kernels/reductions.py::sharer_reductions`: on CUDA tensors it launches
`csrc/sharer_reductions.cu`; on CPU tensors it runs the plain version
below, the same function written as dense torch ops over [C, 32*NW]
target bits. Full-map directory and mesh topology only (the port's
`check_port_supported`).
"""

from __future__ import annotations

import torch

from ..config.machine import MachineConfig
from ..noc import topology
from . import build


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


def _i32(x, C, device):
    """A [C] lane as a contiguous int32 tensor (bool lanes converted)."""
    x = x.to(torch.int32).contiguous()
    if x.shape != (C,) or x.device != device:
        raise ValueError(f"lane must be [{C}] on {device}, got {tuple(x.shape)} on {x.device}")
    return x


def sharer_reductions(
    cfg: MachineConfig, shw, vic_shw, btile, vic_owner, inv_row, vic_valid,
    cid, link_lat, router_lat,
):
    """The kernel on CUDA tensors, its plain version on CPU tensors.
    `link_lat`/`router_lat` are 0-d int32 tensors on the same device."""
    dev = shw.device
    if dev.type == "cpu":
        return sharer_reductions_plain(
            cfg, shw, vic_shw, btile, vic_owner, inv_row, vic_valid, cid,
            link_lat, router_lat,
        )
    if dev.type != "cuda":
        raise ValueError(f"sharer_reductions: unsupported device {dev}")
    C, NW = cfg.n_cores, cfg.n_sharer_words
    for name, x in (("shw", shw), ("vic_shw", vic_shw)):
        if x.dtype != torch.int32 or x.shape != (C, NW) or not x.is_contiguous():
            raise ValueError(f"sharer_reductions: {name} must be contiguous int32 [{C}, {NW}]")
    lanes = [_i32(x, C, dev) for x in (btile, vic_owner, inv_row, vic_valid, cid)]
    scal = [_i32(x.reshape(1), 1, dev) for x in (link_lat, router_lat)]
    outs = [torch.empty(C, dtype=torch.int32, device=dev) for _ in range(5)]
    build.launch(
        "sharer_reductions",
        [shw, vic_shw, *lanes, *scal, *outs],
        [C, NW, cfg.n_tiles, cfg.noc.mesh_x],
        torch.cuda.current_stream(dev),
    )
    return tuple(outs)
