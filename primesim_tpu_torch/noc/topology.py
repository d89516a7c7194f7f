"""NoC topology dispatch (DESIGN.md §25), mesh only in this port.

The JAX package routes every hop count and every route through
`cfg.noc.topology`. The port simulates the mesh; torus and ring raise
PortUnsupportedError.
"""

from __future__ import annotations

from ..config.machine import MachineConfig, PortUnsupportedError
from . import mesh as _mesh


def _require_mesh(topology: str) -> None:
    if topology != "mesh":
        raise PortUnsupportedError("noc.topology", topology)


def coord_hops(topology: str, ax, ay, bx, by):
    """Hop count between tile COORDINATES under `topology`."""
    _require_mesh(topology)
    return _mesh.coord_hops(ax, ay, bx, by)


def hops(cfg: MachineConfig, tile_a, tile_b):
    """Hop count between TILE ids under cfg's topology."""
    _require_mesh(cfg.noc.topology)
    return _mesh.hops(tile_a, tile_b, cfg.noc.mesh_x)


def one_way_lat(cfg: MachineConfig, tile_a, tile_b):
    """One-way message latency: hops*link + (hops+1)*router."""
    h = hops(cfg, tile_a, tile_b)
    return h * cfg.noc.link_lat + (h + 1) * cfg.noc.router_lat


def path_width(cfg: MachineConfig) -> int:
    """The -1-padded route length H of `path_links`."""
    _require_mesh(cfg.noc.topology)
    return max(1, (cfg.noc.mesh_x - 1) + (cfg.noc.mesh_y - 1))


def path_links(cfg: MachineConfig, a, b):
    """Vectorized route a -> b as directed link ids [C, H], -1-padded."""
    _require_mesh(cfg.noc.topology)
    return _mesh.path_links(cfg, a, b)
