"""NoC topology dispatch (DESIGN.md §25): the JAX package's
`noc/topology.py` for the three topologies, mesh, torus and ring.

`cfg.noc.topology` picks the hop count and the route of every message;
all three share the mesh's link numbering (tile*4 + dir), so
`mesh.n_links` and every contention scatter shape are the same for each.
The hop counts work on Python ints, numpy arrays and int32 torch tensors
alike; `path_links` takes torch tensors and equals `route_links`, the
scalar reference walk, link for link. `detour_hops_table` gives the
extra hops a route pays around each failed link, and `detour_stats` is
the scalar fault penalty of one leg that `faults.inject.
leg_fault_penalty` must equal.
"""

from __future__ import annotations

import numpy as np

from ..config.machine import MachineConfig
from . import mesh as _mesh
from . import ring as _ring
from . import torus as _torus


def coord_hops(topology: str, ax, ay, bx, by, mesh_x: int, mesh_y: int):
    """Hop count between tile COORDINATES under `topology`."""
    if topology == "torus":
        return _torus.ring_dist(ax, bx, mesh_x) + _torus.ring_dist(ay, by, mesh_y)
    if topology == "ring":
        direct = _torus.ring_dist(ax, bx, mesh_x)
        via = (
            _torus.ring_dist(ax, 0 * ax, mesh_x)
            + _torus.ring_dist(ay, by, mesh_y)
            + _torus.ring_dist(0 * bx, bx, mesh_x)
        )
        return _torus.where(ay == by, direct, via)
    return _mesh.coord_hops(ax, ay, bx, by)


def hops(cfg: MachineConfig, tile_a, tile_b):
    """Hop count between TILE ids under cfg's topology."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    return coord_hops(
        cfg.noc.topology, tile_a % mx, tile_a // mx, tile_b % mx,
        tile_b // mx, mx, my,
    )


def one_way_lat(cfg: MachineConfig, tile_a, tile_b):
    """One-way message latency: hops*link + (hops+1)*router."""
    h = hops(cfg, tile_a, tile_b)
    return h * cfg.noc.link_lat + (h + 1) * cfg.noc.router_lat


def path_width(cfg: MachineConfig) -> int:
    """The -1-padded route length H of `path_links` for this topology."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    if cfg.noc.topology == "torus":
        return _torus.path_width(mx, my)
    if cfg.noc.topology == "ring":
        return _ring.path_width(mx, my)
    return max(1, (mx - 1) + (my - 1))


def route_links(cfg: MachineConfig, a: int, b: int) -> tuple[int, ...]:
    """Directed link ids on the scalar reference route a -> b."""
    mx, my = cfg.noc.mesh_x, cfg.noc.mesh_y
    if cfg.noc.topology == "torus":
        return _torus.route_links(int(a), int(b), mx, my)
    if cfg.noc.topology == "ring":
        return _ring.route_links(int(a), int(b), mx, my)
    return _mesh.xy_links(int(a), int(b), mx)


def path_links(cfg: MachineConfig, a, b):
    """Vectorized routes a -> b as directed link ids [C, H], -1-padded."""
    if cfg.noc.topology == "torus":
        return _torus.path_links(cfg, a, b)
    if cfg.noc.topology == "ring":
        return _ring.path_links(cfg, a, b)
    return _mesh.path_links(cfg, a, b)


def detour_hops_table(cfg: MachineConfig) -> np.ndarray:
    """[n_links] extra hops a route pays to detour around each directed
    link when FAILED. Mesh and torus pay the orthogonal sidestep (+2
    everywhere); the ring pays the long way around the affected ring."""
    if cfg.noc.topology == "ring":
        return _ring.detour_hops_table(cfg)
    return np.full(cfg.n_tiles * 4, 2, np.int32)


def detour_stats(
    cfg: MachineConfig, a: int, b: int, link_dead, link_extra,
    link_lat: int, router_lat: int,
) -> tuple[int, int, int]:
    """Scalar fault penalty of the one-way leg a -> b under cfg's
    topology: (extra cycles, extra hops, rerouted flag). Each dead link on
    the route adds its detour hops at (link + router) cycles each; each
    live degraded link adds its extra cycles."""
    tbl = detour_hops_table(cfg)
    dead_hops = 0
    extra = 0
    for l in route_links(cfg, a, b):
        if link_dead[l]:
            dead_hops += int(tbl[l])
        else:
            extra += int(link_extra[l])
    return (
        dead_hops * (link_lat + router_lat) + extra,
        dead_hops,
        int(dead_hops > 0),
    )
