"""Reference-schema XML config loader (SURVEY.md §2 #11): a copy of the
JAX package's `config/xml_compat.py` that builds the port's own
`MachineConfig`.

The reference parses an XML simulation config with libxml2 (`XmlParser`
producing `XmlSim`/`XmlCore`/`XmlCache`/`XmlNetwork` structs: core count +
CPI, per-level cache geometry, mesh dims + hop latencies, DRAM latency,
sync quantum — SURVEY.md §5.6). PROVENANCE: the reference checkout was
never delivered (SURVEY.md §0), so the exact element names are
[RECALL]-grade; this loader therefore accepts the documented schema below
*and* common aliases, and fails loudly on anything it cannot map. Layout:

    <sim>
      <sys>
        <num_cores>64</num_cores>
        <cpi_nonmem>1</cpi_nonmem>
        <sync_quantum>1000</sync_quantum>
        <dram_access_time>100</dram_access_time>
        <network>
          <net_width>8</net_width>
          <net_height>8</net_height>
          <link_latency>1</link_latency>
          <router_latency>1</router_latency>
        </network>
        <cache level="1">          <!-- private L1 -->
          <size>32768</size> <num_ways>4</num_ways>
          <line_size>64</line_size> <access_time>2</access_time>
        </cache>
        <cache level="2" shared="true" num_banks="64">   <!-- shared LLC -->
          <size>262144</size> <num_ways>8</num_ways>
          <line_size>64</line_size> <access_time>10</access_time>
        </cache>
      </sys>
    </sim>

Accepted aliases: n_cores/num_cores, quantum/sync_quantum,
dram_latency/dram_access_time, x_dimension/net_width,
y_dimension/net_height, ways/num_ways, latency/access_time.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from .machine import CacheConfig, CoreConfig, MachineConfig, NocConfig

_ALIASES = {
    "n_cores": ("num_cores", "n_cores"),
    "cpi": ("cpi_nonmem", "cpi"),
    "quantum": ("sync_quantum", "quantum"),
    "dram_lat": ("dram_access_time", "dram_latency", "dram_lat"),
    "mesh_x": ("net_width", "x_dimension", "mesh_x"),
    "mesh_y": ("net_height", "y_dimension", "mesh_y"),
    "link_lat": ("link_latency", "link_lat"),
    "router_lat": ("router_latency", "router_lat"),
    "size": ("size",),
    "ways": ("num_ways", "ways", "associativity"),
    "line": ("line_size", "line"),
    "latency": ("access_time", "latency"),
}


def _find_int(
    root: ET.Element, key: str, default: int | None = None, where: str = ""
) -> int:
    for tag in _ALIASES[key]:
        el = root.find(f".//{tag}")
        if el is not None and el.text and el.text.strip():
            return int(el.text.strip())
    if default is not None:
        return default
    ctx = f" in {where}" if where else ""
    raise ValueError(f"xml config: missing element {_ALIASES[key][0]!r}{ctx}")


def _cache_from(el: ET.Element, name: str) -> CacheConfig:
    return CacheConfig(
        size=_find_int(el, "size", where=name),
        ways=_find_int(el, "ways", where=name),
        line=_find_int(el, "line", where=name),
        latency=_find_int(el, "latency", where=name),
    )


def load_xml(path: str) -> MachineConfig:
    """Parse a reference-schema XML file into a MachineConfig."""
    root = ET.parse(path).getroot()

    caches = root.findall(".//cache")
    if not caches:
        raise ValueError("xml config: no <cache> elements")
    private = None
    shared = None
    n_banks = None
    for c in caches:
        is_shared = c.get("shared", "false").lower() in ("true", "1", "yes")
        level = int(c.get("level", "1"))
        if is_shared:
            if shared is not None:
                raise ValueError("xml config: multiple shared cache levels")
            shared = c
            nb = c.get("num_banks")
            n_banks = int(nb) if nb else None
        elif private is None or level < int(private.get("level", "1")):
            private = c  # the innermost private level maps to L1
    if private is None or shared is None:
        raise ValueError(
            "xml config: need one private and one shared (shared=\"true\") "
            "cache level"
        )

    n_cores = _find_int(root, "n_cores")
    noc = NocConfig(
        mesh_x=_find_int(root, "mesh_x", 8),
        mesh_y=_find_int(root, "mesh_y", 8),
        link_lat=_find_int(root, "link_lat", 1),
        router_lat=_find_int(root, "router_lat", 1),
    )
    return MachineConfig(
        n_cores=n_cores,
        core=CoreConfig(cpi=_find_int(root, "cpi", 1)),
        l1=_cache_from(private, "l1"),
        llc=_cache_from(shared, "llc"),
        n_banks=n_banks if n_banks is not None else min(n_cores, 64),
        noc=noc,
        dram_lat=_find_int(root, "dram_lat", 100),
        quantum=_find_int(root, "quantum", 1000),
    )
