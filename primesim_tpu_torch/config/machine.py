"""Machine configuration for primesim_tpu_torch.

A copy of the JAX package's `config/machine.py`: the same typed
dataclasses, validation and JSON loading, so every shipped config file
loads unchanged into either package. The port adds `check_port_supported`,
which names the first field the PyTorch engine cannot simulate yet.

All latencies are integer cycles. Geometry fields used in mask arithmetic
(bank count, cache sets, line size) must be powers of two; the core count
may be arbitrary.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


class FaultConfigError(ValueError):
    """A fault schedule or fault knob is malformed (DESIGN.md §12).

    Mirrors trace.format.TraceError: keyword fields locate the offending
    entry so the CLI prints `fault schedule: core:9 at step 100: ...`
    instead of a bare traceback, and `.location()` feeds structured
    (JSON-line) error reporting.

    `site` names the injection target ("core:3", "link:17"), `step` the
    scheduled step, `field` the offending config/schedule field.
    """

    def __init__(
        self,
        message: str,
        *,
        site: str | None = None,
        step: int | None = None,
        field: str | None = None,
    ):
        self.site = site
        self.step = step
        self.field = field
        where = []
        if site is not None:
            where.append(str(site))
        if step is not None:
            where.append(f"step {step}")
        if field is not None:
            where.append(f"field {field!r}")
        prefix = f"fault schedule: {', '.join(where)}: " if where else "fault schedule: "
        super().__init__(prefix + message)

    def location(self) -> dict:
        """Non-None locator fields, for structured error lines."""
        out = {}
        for k in ("site", "step", "field"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


class ConfigError(ValueError):
    """A machine-zoo model selector is unknown or the combination is
    incompatible (DESIGN.md §25).

    Mirrors FaultConfigError / parallel.sharding.DeviceMeshError: the CLI
    catches it, exits 2 and prints ONE structured `{"error": ...}` JSON
    line, so `topology="taurus"` fails at config load with a typed
    message instead of a mid-compile shape error.

    `selector` names the offending config field ("noc_topology",
    "coherence", "prefetcher"), `value` its rejected value.
    """

    def __init__(
        self,
        message: str,
        *,
        selector: str | None = None,
        value=None,
    ):
        self.selector = selector
        self.value = value
        where = []
        if selector is not None:
            where.append(str(selector))
        if value is not None:
            where.append(f"value {value!r}")
        prefix = (
            f"machine config: {', '.join(where)}: " if where
            else "machine config: "
        )
        super().__init__(prefix + message)

    def location(self) -> dict:
        """Non-None locator fields, for structured error lines."""
        out = {}
        if self.selector is not None:
            out["selector"] = self.selector
        if self.value is not None:
            out["value"] = str(self.value)
        return out


#: Valid static model-selector values (the machine zoo, DESIGN.md §25).
NOC_TOPOLOGIES = ("mesh", "torus", "ring")
COHERENCE_PROTOCOLS = ("mesi", "moesi")
PREFETCHERS = ("none", "stride")


#: Fault event kinds (config/schedule encoding; see faults/schedule.py)
FAULT_CORE_FAILSTOP = 1  # a = core id: fail-stop at the scheduled step
FAULT_LINK_FAIL = 2  # a = directed link id: permanent link failure
FAULT_LINK_DEGRADE = 3  # a = link id, b = extra cycles per traversal


@dataclass(frozen=True)
class CacheConfig:
    """Geometry + latency of one cache level (private L1 or one LLC bank)."""

    size: int  # bytes (per core for L1, per bank for LLC)
    ways: int
    line: int  # line size, bytes
    latency: int  # hit/lookup latency, cycles

    @property
    def sets(self) -> int:
        s = self.size // (self.ways * self.line)
        return s

    def validate(self, name: str) -> None:
        if not _is_pow2(self.line):
            raise ValueError(f"{name}.line must be a power of two, got {self.line}")
        if self.size % (self.ways * self.line) != 0:
            raise ValueError(f"{name}.size not divisible by ways*line")
        if not _is_pow2(self.sets):
            raise ValueError(f"{name}: sets={self.sets} must be a power of two")
        if self.latency < 0:
            raise ValueError(f"{name}.latency must be >= 0")


@dataclass(frozen=True)
class CoreConfig:
    """In-order core timing model (SURVEY.md §2 #2: CoreManager).

    `cpi` is the cycles-per-instruction for non-memory instructions. A
    heterogeneous (big.LITTLE-style) machine supplies `cpi_per_core` (one
    entry per core) or the compact `cpi_pattern` (tiled across cores, e.g.
    (1, 1, 3, 3) for alternating big/LITTLE pairs); per-core overrides
    pattern overrides `cpi`.
    """

    cpi: int = 1
    cpi_per_core: tuple[int, ...] | None = None
    cpi_pattern: tuple[int, ...] | None = None
    # O3-style overlap model (0 = pure in-order). Fraction (in 1/256ths) of a
    # miss latency hidden by the out-of-order window; applied as
    # charged = lat - (lat * o3_overlap_256 >> 8), still integer-exact.
    o3_overlap_256: int = 0

    def cpi_vector(self, n_cores: int) -> tuple[int, ...]:
        if self.cpi_per_core is not None:
            if len(self.cpi_per_core) != n_cores:
                raise ValueError("cpi_per_core length != n_cores")
            return tuple(self.cpi_per_core)
        if self.cpi_pattern is not None:
            p = self.cpi_pattern
            return tuple(p[i % len(p)] for i in range(n_cores))
        return (self.cpi,) * n_cores

    def validate(self) -> None:
        if self.cpi < 1 or (
            self.cpi_per_core is not None and any(c < 1 for c in self.cpi_per_core)
        ):
            raise ValueError("core cpi values must be >= 1")
        if self.cpi_pattern is not None and (
            not self.cpi_pattern or any(c < 1 for c in self.cpi_pattern)
        ):
            raise ValueError("cpi_pattern must be non-empty with values >= 1")
        if not (0 <= self.o3_overlap_256 < 256):
            raise ValueError("o3_overlap_256 must be in [0, 256)")


@dataclass(frozen=True)
class NocConfig:
    """2-D mesh NoC (SURVEY.md §2 #6: Network, XY routing, hop-by-hop).

    `contention=True` enables load-dependent queueing, in one of two
    models (`contention_model`):

    - ``"tile"`` — router occupancy at the HOME tile: every uncore
      transaction served at a tile in the same step (memory winners +
      read-joins at their home bank, lock/unlock RMWs at the lock's home,
      barrier arrivals at the barrier's home) queues behind the others;
      each is charged `contention_lat * (n_at_tile - 1)` extra cycles.
    - ``"link"`` — hop-by-hop per-LINK occupancy: each transaction's XY
      request+reply paths (barrier arrivals: the one-way arrival path)
      claim every directed mesh link they traverse; the charge is
      `contention_lat * max over the path of (link_occupancy - 1)` — the
      bottleneck-link queue. This makes path-crossing traffic contend
      even when home banks differ (BASELINE rung 3 "NoC-congestion
      heavy").
    - ``"router"`` — hop-by-hop router with PER-LINK QUEUE STATE CARRIED
      ACROSS STEPS (SURVEY.md §2 #6's hop-by-hop `Network` router): every
      directed link keeps a next-free-cycle clock (`MachineState.
      link_free`). A transaction's packet walks its XY route hop by hop:
      at each link it waits for `link_free + rank*link_lat` (rank =
      number of same-step packets on that link injected earlier in the
      canonical (clock, core) order — FIFO serialization at `link_lat`
      per packet), then occupies the link for `link_lat` and pays
      `router_lat` at the next router; waits cascade into later hops.
      After the step, each link's clock advances to its last departure.
      Uncontended, the walk reduces exactly to the analytic
      `hops*link_lat + (hops+1)*router_lat`. Probe/invalidation side
      legs keep analytic latency (model scope: request/reply/barrier
      arrival paths route through the queues). `contention_lat` is
      unused by this model.

    All models are implemented identically in the golden and JAX engines
    and charged before the O3 overlap reduction.
    """

    mesh_x: int = 8
    mesh_y: int = 8
    link_lat: int = 1  # per-hop link traversal, cycles
    router_lat: int = 1  # per-router, cycles ((hops+1) routers on a path)
    contention: bool = False
    contention_model: str = "tile"  # "tile" | "link" | "router"
    contention_lat: int = 1  # queueing cycles per concurrent transaction
    # STATIC topology selector (DESIGN.md §25): "mesh" (XY dimension-
    # ordered), "torus" (wrap-around XY, shorter way per ring) or "ring"
    # (one ring per row bridged by a column-0 spine ring). Part of
    # `timing_normalized()` like contention_model — it changes the
    # compiled route builder, never a traced value — so it joins the
    # jit / exec-cache key. All topologies share the mesh link numbering
    # (tile*4 + dir), keeping n_links and every scatter shape invariant.
    topology: str = "mesh"

    @property
    def n_tiles(self) -> int:
        return self.mesh_x * self.mesh_y


@dataclass(frozen=True)
class MachineConfig:
    """Full simulated machine (SURVEY.md §2 #11 `XmlSim` equivalent)."""

    n_cores: int = 64
    core: CoreConfig = field(default_factory=CoreConfig)
    l1: CacheConfig = field(default_factory=lambda: CacheConfig(32 * 1024, 4, 64, 2))
    llc: CacheConfig = field(default_factory=lambda: CacheConfig(256 * 1024, 8, 64, 10))
    n_banks: int = 64
    noc: NocConfig = field(default_factory=NocConfig)
    dram_lat: int = 100
    # Memory-controller queueing (SURVEY.md §2 #7's "later: queueing
    # model per controller"): each LLC bank's co-located controller keeps
    # a next-free clock carried across steps; a miss whose request
    # arrives while the controller is busy waits for
    # `max(dram_free[bank], base) + rank*dram_service` (rank = earlier
    # same-step misses to the bank in (clock, core) order, base = the
    # bank's earliest nominal arrival this step — the same FIFO shape as
    # the router NoC model). `dram_service` is the controller occupancy
    # per access (0 -> dram_lat, a fully serialized controller). Waits
    # are charged before the O3 reduction and counted in
    # `dram_queue_cycles`; golden and engine are bit-exact.
    dram_queue: bool = False
    dram_service: int = 0
    # JAX package selector (route its dense sharer reductions through its
    # Pallas kernel). Kept so configs load unchanged; the port ignores it.
    pallas_reduce: bool = False
    quantum: int = 1000  # relaxed-sync quantum, cycles (the fidelity/speed knob)
    # Local-run length: how many LOCAL events (INS batches, L1 hits) each
    # core may retire per step BEFORE the one arbitrated uncore event
    # (DESIGN.md §3 "local runs"). 0 = one event per core per step. This is
    # the analogue of the reference frontend never crossing a process
    # boundary for non-miss work (SURVEY.md §3.2): private hits shouldn't
    # cost a simulation step.
    local_run_len: int = 0
    # Synchronization modeling (DESIGN.md §3-sync; the reference intercepts
    # pthread mutex/barrier calls, SURVEY.md §2 #1). Mutex addresses hash
    # into `lock_slots` table entries (collisions = conservative false
    # contention); barrier ids must be dense ints < `barrier_slots`.
    lock_slots: int = 1024
    barrier_slots: int = 64
    # Sharer-reduction chunking (BASELINE rungs 4-5 memory bound): 0 =
    # dense [C, C] expansion of sharer bit-vectors for invalidation/
    # back-invalidation reductions (fastest at <= 1024 cores); K > 0 =
    # lax.scan over K-word blocks of the packed sharer words, bounding
    # per-step temporaries to [C, 32K] instead of [C, C] (4096+ cores).
    # Bit-exact either way. K must divide n_sharer_words.
    sharer_chunk_words: int = 0
    # COARSE SHARER VECTOR (Dir-G; SURVEY.md §2 #4, BASELINE rung 5): each
    # directory bit covers a GROUP of `sharer_group` consecutive cores,
    # dividing sharer storage by G — the full-map vector at 16384 cores x
    # 16.8M entries is 256 GiB, impossible on any chip; G=64 makes it
    # ~1 GiB. 1 = exact full-map. G > 1 is CONSERVATIVE, the classic
    # coarse-vector trade (Gupta et al.): invalidations broadcast to every
    # core of each flagged group (the requester is skipped as a message
    # but still bounds the serialization latency), a line is exclusive
    # (E-grantable) only when NO group bit is set, and read-join
    # coalescing is disabled (same-group joiners' bit updates would not
    # commute). Both engines implement the identical model; parity is
    # proven at small scale with G in {4, 32} (tests/test_coarse.py).
    sharer_group: int = 1
    # JAX package selector between its XLA and Pallas step bodies (DESIGN.md
    # §11). Kept so configs load unchanged; the port always runs its own
    # kernels (check_port_supported).
    step_impl: str = "xla"
    # ---- machine zoo selectors (DESIGN.md §25) --------------------------
    # STATIC coherence selector: "mesi" (the default pull-based protocol)
    # or "moesi" — adds the Owned state: a GETS to a modified line leaves
    # the dirty copy with its owner (no downgrade writeback) while other
    # sharers are recorded; O is DERIVED from the directory (owner == c
    # with other sharers), never stored in the L1 plane, so the state
    # encoding and every kernel layout are unchanged. Requires
    # sharer_group == 1 (a coarse group bit cannot distinguish the owner
    # from its own group's other cores).
    coherence: str = "mesi"
    # STATIC per-core prefetcher selector: "none" or "stride" (a stride-
    # detecting line prefetcher trained on each core's arbitrated uncore
    # stream; hits replace the DRAM latency of an LLC miss with the
    # traced `prefetch_lat`). The DEGREE and latency are TRACED knobs
    # (TimingKnobs.prefetch_degree / prefetch_lat) so a calibrate/sweep
    # fan over them never recompiles.
    prefetcher: str = "none"
    prefetch_degree: int = 4  # lines ahead a trained stream covers
    prefetch_lat: int = 0  # cycles an LLC miss costs on a prefetch hit
    # ---- fault injection (DESIGN.md §12) --------------------------------
    # `faults_enabled` is a STATIC model selector: when False (default)
    # the step function never touches the fault state and the compiled
    # graph is IDENTICAL to a build without the subsystem — the faults-off
    # bit-exactness + zero-overhead contract holds by construction.
    faults_enabled: bool = False
    # STATIC schedule capacity (array geometry, part of the jit key):
    # the scheduled events live in [max_fault_events]-sized traced arrays.
    max_fault_events: int = 0
    # STATIC policy selectors: what happens to a dead core's owned
    # (dirty-conservative) L1 lines — "writeback" keeps them in the LLC
    # (ownerless), "drop" invalidates the LLC entries too; whether an L1
    # detected-uncorrectable ECC error escalates to a core fail-stop.
    fault_dead_policy: str = "writeback"
    fault_due_failstop: bool = False
    # TRACED fault knobs (carried into state.FaultState by init_state and
    # blanked by timing_normalized, exactly like the timing knobs): the
    # PRNG seed, the scheduled events (step, kind, a, b) — kinds are the
    # FAULT_* constants above — and the per-site per-step bit-flip /
    # DUE-classification probabilities. A `sweep --vary fault_seed`
    # fan-out therefore NEVER recompiles.
    fault_seed: int = 0
    fault_events: tuple = ()
    fault_flip_l1: float = 0.0
    fault_flip_llc: float = 0.0
    fault_due_rate: float = 0.0

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.n_cores < 1:
            raise ValueError("n_cores must be >= 1")
        if not _is_pow2(self.n_banks):
            raise ValueError("n_banks must be a power of two")
        self.core.validate()
        self.l1.validate("l1")
        self.llc.validate("llc")
        if self.l1.line != self.llc.line:
            raise ValueError("l1 and llc line sizes must match")
        if self.quantum <= 0:
            raise ValueError("quantum must be positive")
        if self.dram_lat < 0:
            raise ValueError("dram_lat must be >= 0")
        if self.dram_service < 0:
            raise ValueError("dram_service must be >= 0")
        if self.noc.link_lat < 0 or self.noc.router_lat < 0:
            raise ValueError("NoC latencies must be >= 0")
        if self.noc.contention_lat < 0:
            raise ValueError("contention_lat must be >= 0")
        if self.noc.contention_model not in ("tile", "link", "router"):
            raise ValueError(
                "contention_model must be 'tile', 'link' or 'router'"
            )
        if self.noc.mesh_x < 1 or self.noc.mesh_y < 1:
            raise ValueError("mesh dims must be >= 1")
        if self.noc.topology not in NOC_TOPOLOGIES:
            raise ConfigError(
                f"unknown NoC topology (have: {', '.join(NOC_TOPOLOGIES)})",
                selector="noc_topology", value=self.noc.topology,
            )
        if self.coherence not in COHERENCE_PROTOCOLS:
            raise ConfigError(
                "unknown coherence protocol (have: "
                f"{', '.join(COHERENCE_PROTOCOLS)})",
                selector="coherence", value=self.coherence,
            )
        if self.coherence == "moesi" and self.sharer_group > 1:
            raise ConfigError(
                "moesi requires sharer_group == 1: the derived Owned "
                "state needs exact sharer identity, which a coarse "
                "group bit cannot provide",
                selector="coherence", value="moesi",
            )
        if self.prefetcher not in PREFETCHERS:
            raise ConfigError(
                f"unknown prefetcher (have: {', '.join(PREFETCHERS)})",
                selector="prefetcher", value=self.prefetcher,
            )
        if self.prefetch_degree < 1:
            raise ConfigError(
                "prefetch_degree must be >= 1",
                selector="prefetch_degree", value=self.prefetch_degree,
            )
        if self.prefetch_lat < 0:
            raise ConfigError(
                "prefetch_lat must be >= 0",
                selector="prefetch_lat", value=self.prefetch_lat,
            )
        if not (0 <= self.local_run_len <= 64):
            raise ValueError("local_run_len must be in [0, 64]")
        if not _is_pow2(self.lock_slots):
            raise ValueError("lock_slots must be a power of two")
        if not _is_pow2(self.barrier_slots):
            raise ValueError("barrier_slots must be a power of two")
        if not _is_pow2(self.sharer_group):
            raise ValueError("sharer_group must be a power of two >= 1")
        if self.pallas_reduce and (
            self.sharer_group > 1 or self.sharer_chunk_words
        ):
            raise ValueError(
                "pallas_reduce covers the dense full-map reduction only "
                "(sharer_group == 1, sharer_chunk_words == 0)"
            )
        if self.step_impl not in ("xla", "pallas"):
            raise ValueError("step_impl must be 'xla' or 'pallas'")
        if self.sharer_chunk_words < 0:
            raise ValueError("sharer_chunk_words must be >= 0")
        if self.sharer_chunk_words and (
            self.n_sharer_words % self.sharer_chunk_words
        ):
            raise ValueError(
                f"sharer_chunk_words={self.sharer_chunk_words} must divide "
                f"n_sharer_words={self.n_sharer_words}"
            )
        self._validate_faults()

    def _validate_faults(self) -> None:
        """Fault-injection knob validation (typed FaultConfigError)."""
        if self.fault_dead_policy not in ("writeback", "drop"):
            raise FaultConfigError(
                f"fault_dead_policy must be 'writeback' or 'drop', got "
                f"{self.fault_dead_policy!r}",
                field="fault_dead_policy",
            )
        if self.max_fault_events < 0:
            raise FaultConfigError(
                "max_fault_events must be >= 0", field="max_fault_events"
            )
        for name in ("fault_flip_l1", "fault_flip_llc", "fault_due_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise FaultConfigError(
                    f"{name}={v} must be a probability in [0, 1]", field=name
                )
        if len(self.fault_events) > self.max_fault_events:
            raise FaultConfigError(
                f"{len(self.fault_events)} scheduled events exceed "
                f"max_fault_events={self.max_fault_events}",
                field="max_fault_events",
            )
        nl = self.n_tiles * 4  # directed links (noc.mesh.n_links)
        for ev in self.fault_events:
            if len(ev) != 4:
                raise FaultConfigError(
                    f"event {ev!r} must be (step, kind, a, b)",
                    field="fault_events",
                )
            estep, kind, a, b = (int(x) for x in ev)
            if estep < 0:
                raise FaultConfigError(
                    "scheduled step must be >= 0", step=estep,
                    field="fault_events",
                )
            if kind == FAULT_CORE_FAILSTOP:
                if not (0 <= a < self.n_cores):
                    raise FaultConfigError(
                        f"core id {a} out of range [0, {self.n_cores})",
                        site=f"core:{a}", step=estep, field="fault_events",
                    )
                if self.sharer_group > 1:
                    raise FaultConfigError(
                        "core fail-stop requires sharer_group == 1: a "
                        "coarse group bit covers live neighbors, so the "
                        "dead core's sharer bits cannot be scrubbed "
                        "without invalidating them too",
                        site=f"core:{a}", step=estep, field="sharer_group",
                    )
            elif kind in (FAULT_LINK_FAIL, FAULT_LINK_DEGRADE):
                if not (0 <= a < nl):
                    raise FaultConfigError(
                        f"link id {a} out of range [0, {nl})",
                        site=f"link:{a}", step=estep, field="fault_events",
                    )
                if self.noc.topology == "ring":
                    # a ring's only fallback is the LONG way around the
                    # affected ring (noc/ring.py detour_hops_table), which
                    # needs >= 3 positions to exist
                    if self.noc.mesh_x < 3 or self.noc.mesh_y < 3:
                        raise FaultConfigError(
                            "ring link faults need mesh_x >= 3 and "
                            "mesh_y >= 3 (the detour is the long way "
                            "around the affected ring)",
                            site=f"link:{a}", step=estep, field="noc",
                        )
                elif self.noc.mesh_x < 2 or self.noc.mesh_y < 2:
                    raise FaultConfigError(
                        "link faults need a >= 2x2 mesh (the X-Y fallback "
                        "detours around the failed hop through an "
                        "adjacent row/column)",
                        site=f"link:{a}", step=estep, field="noc",
                    )
                if kind == FAULT_LINK_DEGRADE and b < 0:
                    raise FaultConfigError(
                        "degrade extra latency must be >= 0",
                        site=f"link:{a}", step=estep, field="fault_events",
                    )
            else:
                raise FaultConfigError(
                    f"unknown fault kind {kind}", step=estep,
                    field="fault_events",
                )

    def timing_normalized(self) -> "MachineConfig":
        """This config with every TRACED timing knob (sim.state.TimingKnobs:
        quantum, cpi, cache/NoC/DRAM latencies) replaced by a fixed
        placeholder. Geometry and model selectors survive untouched, so two
        configs agree here iff they can share one compiled program — the
        fleet engine's static jit key (timing comes from the traced knobs
        carried in state, never from this config)."""
        return dataclasses.replace(
            self,
            quantum=1,
            core=dataclasses.replace(
                self.core, cpi=1, cpi_per_core=None, cpi_pattern=None
            ),
            l1=dataclasses.replace(self.l1, latency=1),
            llc=dataclasses.replace(self.llc, latency=1),
            noc=dataclasses.replace(
                self.noc, link_lat=1, router_lat=1, contention_lat=1
            ),
            dram_lat=1,
            dram_service=0,
            # traced prefetcher knobs blank too (they ride in
            # state.TimingKnobs); the `prefetcher` SELECTOR survives
            prefetch_degree=1,
            prefetch_lat=1,
            # traced fault knobs blank out too (seed/schedule/rates ride
            # in state.FaultState); the STATIC selectors (faults_enabled,
            # max_fault_events, policies) survive — they change the graph
            fault_seed=0,
            fault_events=(),
            fault_flip_l1=0.0,
            fault_flip_llc=0.0,
            fault_due_rate=0.0,
        )

    # Derived geometry used by both engines --------------------------------

    @property
    def line_bits(self) -> int:
        return self.l1.line.bit_length() - 1

    @property
    def n_sharer_groups(self) -> int:
        return (self.n_cores + self.sharer_group - 1) // self.sharer_group

    @property
    def n_sharer_words(self) -> int:
        return (self.n_sharer_groups + 31) // 32

    @property
    def n_tiles(self) -> int:
        return self.noc.n_tiles

    # Serialization --------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MachineConfig":
        # keys starting with "_" are annotations ("_comment"), not fields
        d = {k: v for k, v in d.items() if not k.startswith("_")}
        if "core" in d and isinstance(d["core"], dict):
            c = dict(d["core"])
            if c.get("cpi_per_core") is not None:
                c["cpi_per_core"] = tuple(c["cpi_per_core"])
            if c.get("cpi_pattern") is not None:
                c["cpi_pattern"] = tuple(c["cpi_pattern"])
            d["core"] = CoreConfig(**c)
        if "l1" in d and isinstance(d["l1"], dict):
            d["l1"] = CacheConfig(**d["l1"])
        if "llc" in d and isinstance(d["llc"], dict):
            d["llc"] = CacheConfig(**d["llc"])
        if "noc" in d and isinstance(d["noc"], dict):
            d["noc"] = NocConfig(**d["noc"])
        if "fault_events" in d and d["fault_events"] is not None:
            d["fault_events"] = tuple(
                tuple(int(x) for x in ev) for ev in d["fault_events"]
            )
        return MachineConfig(**d)

    @staticmethod
    def from_json(s: str) -> "MachineConfig":
        return MachineConfig.from_dict(json.loads(s))


def small_test_config(n_cores: int = 4, **kw) -> MachineConfig:
    """Tiny machine for unit tests: 4 cores, 2x2 mesh, small caches."""
    defaults = dict(
        n_cores=n_cores,
        l1=CacheConfig(size=1024, ways=2, line=64, latency=2),
        llc=CacheConfig(size=4096, ways=4, line=64, latency=10),
        n_banks=1 << (min(4, n_cores).bit_length() - 1),  # pow2 <= min(4, n)
        noc=NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1),
        dram_lat=100,
        quantum=1000,
    )
    defaults.update(kw)
    return MachineConfig(**defaults)


class PortUnsupportedError(ValueError):
    """A config field selects a model the PyTorch port does not run yet.
    `field` names the field, `value` its rejected value."""

    def __init__(self, field: str, value):
        self.field = field
        self.value = value
        super().__init__(
            f"primesim_tpu_torch does not support {field}={value!r} yet"
        )


def check_port_supported(cfg: MachineConfig) -> None:
    """Raise PortUnsupportedError for the first field outside what the
    port simulates: every machine of the JAX package's one-device run
    path except fault injection. That is MESI or MOESI on a mesh, torus
    or ring NoC, a full-map (dense or chunked, `sharer_chunk_words`) or
    coarse (`sharer_group` > 1) sharer vector, with or without NoC
    contention (the tile, link and router models), the DRAM controller
    queue and the stride prefetcher.

    `step_impl` and `pallas_reduce` are accepted and ignored: they choose
    between the JAX package's XLA and Pallas step bodies, while the port
    always runs its own kernels on a card (and their plain versions on
    the CPU)."""
    if cfg.faults_enabled:
        raise PortUnsupportedError("faults_enabled", cfg.faults_enabled)
