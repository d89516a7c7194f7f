"""Multi-ring NoC topology (DESIGN.md §25), the port's copy of the JAX
package's `noc/ring.py`.

One horizontal ring per row plus ONE vertical ring at column 0: row rings
bridged by a spine. A message between rows takes three legs, each the
shorter way around its ring: along the source row to column 0, along the
spine to the destination row, then along that row to the target column.
Same-row traffic stays on its row ring. Link ids reuse the mesh
numbering (tile*4 + dir, 0=E 1=W 2=N 3=S); the vertical links off the
spine never carry traffic.

`hops` works on Python ints, numpy arrays and int32 torch tensors alike;
`route_links` is the memoized scalar reference walk and `path_links` the
vectorized torch builder, equal to it link for link.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config.machine import MachineConfig
from .torus import ring_dist, ring_step, shorter_way, where


def hops(tile_a, tile_b, mesh_x: int, mesh_y: int):
    ax, ay = tile_a % mesh_x, tile_a // mesh_x
    bx, by = tile_b % mesh_x, tile_b // mesh_x
    direct = ring_dist(ax, bx, mesh_x)
    via = (
        ring_dist(ax, 0 * ax, mesh_x)
        + ring_dist(ay, by, mesh_y)
        + ring_dist(0 * bx, bx, mesh_x)
    )
    return where(ay == by, direct, via)


def path_width(mesh_x: int, mesh_y: int) -> int:
    """Max route length: two half row-rings plus half the spine."""
    return max(1, 2 * (mesh_x // 2) + mesh_y // 2)


@functools.lru_cache(maxsize=None)
def route_links(a: int, b: int, mesh_x: int, mesh_y: int) -> tuple[int, ...]:
    """Directed link ids on the ring route tile a -> tile b (scalar)."""
    ax, ay = a % mesh_x, a // mesh_x
    bx, by = b % mesh_x, b // mesh_x
    links = []

    def row_leg(y: int, x0: int, x1: int) -> None:
        s, n = ring_step(x0, x1, mesh_x)
        x = x0
        for _ in range(n):
            links.append((y * mesh_x + x) * 4 + (0 if s > 0 else 1))
            x = (x + s) % mesh_x

    if ay == by:
        row_leg(ay, ax, bx)
        return tuple(links)
    row_leg(ay, ax, 0)
    s, n = ring_step(ay, by, mesh_y)
    y = ay
    for _ in range(n):
        links.append((y * mesh_x + 0) * 4 + (2 if s > 0 else 3))
        y = (y + s) % mesh_y
    row_leg(by, 0, bx)
    return tuple(links)


def path_links(cfg: MachineConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ring routes a[i] -> b[i] as directed link ids, [..., C, H]
    int32 (an element axis of `a` or `b` carries through), -1-padded to
    the diameter: three concatenated shorter-way legs (source row to the
    spine, spine to the destination row, destination row), only the
    first when the rows match."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    H = path_width(mx, my)
    ax, ay = a % mx, a // mx
    bx, by = b % mx, b // mx
    same = ay == by
    i = torch.arange(H, dtype=torch.int32, device=a.device)[None, :]

    def dirn(pos, base):  # link direction: base (+) or base + 1 (-)
        return base + (~pos).to(torch.int32)[..., None]

    # leg 1: row ay's ring, ax -> (bx when same row, else the spine at 0)
    pos1, s1, n1 = shorter_way(ax, torch.where(same, bx, 0), mx)
    p1 = (ax[..., None] + s1[..., None] * i) % mx
    l1 = (ay[..., None] * mx + p1) * 4 + dirn(pos1, 0)
    # leg 2: the column-0 spine, ay -> by (none when same row)
    pos2, s2, n2 = shorter_way(ay, by, my)
    n2 = torch.where(same, 0, n2)
    j = i - n1[..., None]
    p2 = (ay[..., None] + s2[..., None] * j) % my
    l2 = (p2 * mx) * 4 + dirn(pos2, 2)
    # leg 3: row by's ring, 0 -> bx (none when same row)
    pos3, s3, n3 = shorter_way(torch.zeros_like(bx), bx, mx)
    n3 = torch.where(same, 0, n3)
    k = j - n2[..., None]
    p3 = (s3[..., None] * k) % mx
    l3 = (by[..., None] * mx + p3) * 4 + dirn(pos3, 0)
    return torch.where(
        i < n1[..., None],
        l1,
        torch.where(j < n2[..., None], l2, torch.where(k < n3[..., None], l3, -1)),
    )


def detour_hops_table(cfg: MachineConfig) -> np.ndarray:
    """Extra hops to detour around each FAILED directed link: a ring has no
    orthogonal sidestep, so the fallback is the long way around the same
    ring, (m - 1) hops replacing 1. Row-ring links (dirs 0/1) pay
    mesh_x - 2, spine links (dirs 2/3) mesh_y - 2 (config validation
    requires both sides >= 3 for ring link faults)."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    tbl = np.empty((cfg.n_tiles, 4), np.int32)
    tbl[:, 0:2] = mx - 2
    tbl[:, 2:4] = my - 2
    return tbl.reshape(-1)
