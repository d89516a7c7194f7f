"""NoC topology dispatch (DESIGN.md §25): the JAX package's
`noc/topology.py` for the three topologies, mesh, torus and ring.

`cfg.noc.topology` picks the hop count and the route of every message;
all three share the mesh's link numbering (tile*4 + dir), so
`mesh.n_links` and every contention scatter shape are the same for each.
The hop counts work on Python ints, numpy arrays and int32 torch tensors
alike; `path_links` takes torch tensors and equals `route_links`, the
scalar reference walk, link for link. The fault model's detour tables
are not ported yet (faults are `check_port_supported`'s last refusal).
"""

from __future__ import annotations

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
