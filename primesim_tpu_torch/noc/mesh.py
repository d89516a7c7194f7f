"""2-D mesh NoC geometry and analytic latency (DESIGN.md §1).

The port's copy of the JAX package's mesh helpers. Every function works
on Python ints, numpy arrays and int32 torch tensors alike: `%`, `//` and
`abs` floor and wrap the same way in all three.
"""

from __future__ import annotations

import functools

import torch

from ..config.machine import MachineConfig


def tile_xy(tile, mesh_x: int):
    return tile % mesh_x, tile // mesh_x


def coord_hops(ax, ay, bx, by):
    """XY hop count between tile coordinates."""
    return abs(ax - bx) + abs(ay - by)


def hops(tile_a, tile_b, mesh_x: int):
    ax, ay = tile_xy(tile_a, mesh_x)
    bx, by = tile_xy(tile_b, mesh_x)
    return coord_hops(ax, ay, bx, by)


def one_way_lat(tile_a, tile_b, cfg: MachineConfig):
    """One-way message latency: hops*link + (hops+1)*router."""
    h = hops(tile_a, tile_b, cfg.noc.mesh_x)
    return h * cfg.noc.link_lat + (h + 1) * cfg.noc.router_lat


def core_tile(core, cfg: MachineConfig):
    return core % cfg.n_tiles


def bank_tile(bank, cfg: MachineConfig):
    return bank % cfg.n_tiles


# Directed links of the per-link contention models: each tile sources
# four links, id = tile*4 + dir with dir 0=E (+x), 1=W (-x), 2=N (+y),
# 3=S (-y). XY routing takes the x-phase links along the source row,
# then the y-phase links along the destination column. `xy_links` is the
# scalar reference walk that `path_links` matches link for link.


def n_links(cfg: MachineConfig) -> int:
    return cfg.n_tiles * 4


@functools.lru_cache(maxsize=None)
def xy_links(a: int, b: int, mesh_x: int) -> tuple[int, ...]:
    """Directed link ids on the XY route tile a -> tile b (scalar)."""
    ax, ay = a % mesh_x, a // mesh_x
    bx, by = b % mesh_x, b // mesh_x
    links = []
    x, y = ax, ay
    while x != bx:
        links.append((y * mesh_x + x) * 4 + (0 if bx > x else 1))
        x += 1 if bx > x else -1
    while y != by:
        links.append((y * mesh_x + x) * 4 + (2 if by > y else 3))
        y += 1 if by > y else -1
    return tuple(links)


def path_links(cfg: MachineConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The XY routes a[i] -> b[i] as directed link ids, [..., C, H] int32
    (an element axis of `a` or `b` carries through), -1-padded to the
    mesh diameter H = (mx-1) + (my-1) (at least 1)."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    H = max(1, (mx - 1) + (my - 1))
    ax, ay = (a % mx)[..., None], (a // mx)[..., None]
    bx, by = (b % mx)[..., None], (b // mx)[..., None]
    i = torch.arange(H, dtype=torch.int32, device=a.device)[None, :]
    sx, nx = torch.sign(bx - ax), (bx - ax).abs()
    xlink = (ay * mx + ax + sx * i) * 4 + (sx <= 0).to(torch.int32)
    sy, ny = torch.sign(by - ay), (by - ay).abs()
    j = i - nx
    ylink = ((ay + sy * j) * mx + bx) * 4 + 2 + (sy <= 0).to(torch.int32)
    return torch.where(i < nx, xlink, torch.where(j < ny, ylink, -1))


def concat_legs(legs):
    """Per-leg routes and their lane masks in the contention models'
    [..., C, legs*H] layout: `legs` is a sequence of (path_links result
    [..., C, H], lane mask [..., C]) pairs. Returns the concatenated
    routes and the masks broadcast to them, so that every per-link
    operation runs once over all legs."""
    shape = [(*m.shape, p.shape[-1]) for p, m in legs]
    pths = [p.expand(s) for (p, _), s in zip(legs, shape)]
    masks = [m[..., None].expand(s) for (_, m), s in zip(legs, shape)]
    return torch.cat(pths, -1), torch.cat(masks, -1)
