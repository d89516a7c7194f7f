"""2-D torus NoC topology (DESIGN.md §25), the port's copy of the JAX
package's `noc/torus.py`.

The mesh with wrap-around edges: XY dimension-ordered routing, but each
phase takes the SHORTER way around its ring (ties break toward the
positive direction). Link ids reuse the mesh numbering, id = tile*4 + dir
with dir 0=E (+x), 1=W (-x), 2=N (+y), 3=S (-y), so `mesh.n_links` and the
contention models' scatter shapes are unchanged.

`ring_dist` and `hops` work on Python ints, numpy arrays and int32 torch
tensors alike; `route_links` is the memoized scalar reference walk and
`path_links` the vectorized torch builder, equal to it link for link.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config.machine import MachineConfig


def minimum(a, b):
    """Elementwise minimum of two ints, numpy arrays or torch tensors."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))
    return np.minimum(a, b)


def where(cond, a, b):
    """Elementwise select over ints, numpy arrays or torch tensors."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def ring_dist(a, b, m: int):
    """Shortest distance between positions a and b on a ring of m tiles."""
    d = abs(a - b)
    return minimum(d, m - d)


def hops(tile_a, tile_b, mesh_x: int, mesh_y: int):
    ax, ay = tile_a % mesh_x, tile_a // mesh_x
    bx, by = tile_b % mesh_x, tile_b // mesh_x
    return ring_dist(ax, bx, mesh_x) + ring_dist(ay, by, mesh_y)


def path_width(mesh_x: int, mesh_y: int) -> int:
    """Max route length (torus diameter): half of each ring."""
    return max(1, mesh_x // 2 + mesh_y // 2)


def ring_step(a: int, b: int, m: int) -> tuple[int, int]:
    """Scalar (direction, count) of the shortest way a -> b around a ring
    of m positions; ties break positive (as `path_links` does)."""
    dpos = (b - a) % m
    dneg = (a - b) % m
    return (1, dpos) if dpos <= dneg else (-1, dneg)


@functools.lru_cache(maxsize=None)
def route_links(a: int, b: int, mesh_x: int, mesh_y: int) -> tuple[int, ...]:
    """Directed link ids on the torus route tile a -> tile b (scalar)."""
    ax, ay = a % mesh_x, a // mesh_x
    bx, by = b % mesh_x, b // mesh_x
    links = []
    s, n = ring_step(ax, bx, mesh_x)
    x = ax
    for _ in range(n):
        links.append((ay * mesh_x + x) * 4 + (0 if s > 0 else 1))
        x = (x + s) % mesh_x
    s, n = ring_step(ay, by, mesh_y)
    y = ay
    for _ in range(n):
        links.append((y * mesh_x + bx) * 4 + (2 if s > 0 else 3))
        y = (y + s) % mesh_y
    return tuple(links)


def shorter_way(a, b, m: int):
    """Per lane, the shorter way a -> b around a ring of m positions as
    (positive?, step sign, count); ties break positive. int32 tensors."""
    dp = (b - a) % m
    dn = (a - b) % m
    pos = dp <= dn
    return pos, torch.where(pos, 1, -1).to(torch.int32), torch.minimum(dp, dn)


def path_links(cfg: MachineConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The torus routes a[i] -> b[i] as directed link ids, [..., C, H]
    int32 (an element axis of `a` or `b` carries through), -1-padded to
    the diameter: the shorter-way x phase along the source row, then the
    shorter-way y phase along the destination column."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    H = path_width(mx, my)
    ax, ay = a % mx, a // mx
    bx, by = b % mx, b // mx
    i = torch.arange(H, dtype=torch.int32, device=a.device)[None, :]
    posx, sx, nx = shorter_way(ax, bx, mx)
    px = (ax[..., None] + sx[..., None] * i) % mx
    xlink = (ay[..., None] * mx + px) * 4 + (~posx).to(torch.int32)[..., None]
    posy, sy, ny = shorter_way(ay, by, my)
    j = i - nx[..., None]
    py = (ay[..., None] + sy[..., None] * j) % my
    ylink = (py * mx + bx[..., None]) * 4 + 2 + (~posy).to(torch.int32)[..., None]
    return torch.where(
        i < nx[..., None], xlink, torch.where(j < ny[..., None], ylink, -1)
    )
