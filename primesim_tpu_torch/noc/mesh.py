"""2-D mesh NoC geometry and analytic latency (DESIGN.md §1).

The port's copy of the JAX package's mesh helpers. Every function works
on Python ints, numpy arrays and int32 torch tensors alike: `%`, `//` and
`abs` floor and wrap the same way in all three.
"""

from __future__ import annotations

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
