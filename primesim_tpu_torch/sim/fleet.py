"""FleetEngine: B independent simulations of one geometry through one set
of launches a step, the JAX package's `sim/fleet.py` for the port.

A parameter sweep is the common shape of PriME's traffic: many runs of
one machine that differ in their trace and in their timing knobs. The
port's step (`sim/engine.py::step`) is batch-first, so a fleet is one
batched state [B, ...] on the card and every step issues the launches of
ONE step whatever B is: each of the four kernels once, over all B·C
cores, each element reading its own L1s, directory, link clocks and
latency knobs. Per-element timing knobs (`KNOB_KEYS`) are data in the
state's `knobs` ([B] each, `cpi` [B, C]); the geometry and the model
selectors are shared (`cfg.timing_normalized()` is the same for every
element).

Two run modes, as in the JAX package:

- `run` freezes a finished element at its own chunk boundary, step
  counter included, as the JAX fleet's select-masked `while_loop` does:
  the chunk's steps pass each element a live flag, and a finished
  element's steps are no-ops but for the step counter, which the flag
  holds still. No state is copied to do it.
- `run_steps` steps every element, so a finished element's `state.step`
  runs ahead while the rest of its state stays bit-exact (the JAX
  package's vmapped scan).

Either way element i equals a solo `Engine` on `elem_cfgs[i]` and
`traces[i]` (`apply_overrides`) and the JAX `FleetEngine`'s element i,
bit for bit (tests/test_torch_fleet.py). Each chunk ends with one host
transfer for the whole fleet: the [B, NC, C] counters, the [B] rebase
deltas and the [B] live flags. Under faults the scrub runs on the union
of the stepping elements' `kill_possible` steps, which is exact (the
scrub is the identity where nobody dies).

Prefix forking (`fork_element`, DESIGN.md §16) overlays a shared
prefix's snapshot into a slot and reseeds the slot's own inputs
(`sim/prefix.py` runs the prefix).

Slot surgery for the serving daemon (serve/scheduler.py): `make_slots`
builds an all-idle fleet whose event rows hold up to a fixed capacity
(`min_events_capacity`) and whose sync phase is always on
(`force_sync`), so its shapes never change while jobs come and go;
`replace_element` splices a workload into a slot (its event row, a fresh
init state, zeroed host accumulators), `clear_element` retires a slot to
the idle workload, `restore_element` overlays an element checkpoint, and
`upload_events` copies the splices' event rows to the card once per
serving tick. A splice writes one row of the batched state in place, so
it drops the host's cached live flags and step numbers (`_host`).

Attestation (`self.attest`, an `attest.FleetAttest` or None): after each
chunk's drain and rebase, the elements live at the chunk's start advance
their chains, so a fleet element's head equals its solo run's. The chaos
site `fleet.counters` may flip a drained host counter just before that.

Overlapped dispatch (`overlap`, the JAX fleet's): after a committed
chunk the next one is speculated on a copy of the batched state (on a
card, on a side stream: `sim/engine.py::prefetch`) and adopted by the
next chunk if the state is still its source and the run mode the same;
every splice, overlay, fork, event upload and checkpoint load drops it
first. `warm_exec` loads (or builds) the kernels the fleet launches
through the kernel build cache, without running a step.

On a tile mesh (`mesh=`, `parallel/sharding.py`) the batch axis stays
whole and each element's cores and banks shard within it (the JAX
fleet's shard x vmap): the step is the engine's sharded step, and slot
surgery copies each shard's block of an element.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..chaos import sites as chaos
from ..config.machine import MachineConfig, check_port_supported
from ..convert import to_host
from ..faults import inject
from ..faults.schedule import fault_state_from_config
from ..stats.counters import COUNTER_NAMES
from ..trace.format import EV_BARRIER, EV_END, EV_LOCK, EV_UNLOCK, Trace, validate_sync
from .engine import (
    _ACC_BITS,
    _devices,
    _zeros_like,
    adopt,
    drain_rebase,
    drop,
    event_types,
    group_tables,
    kernels_of,
    not_done,
    prefetch,
    resolve_device,
    run_chunk,
)
from .state import (
    MachineState,
    Shards,
    copy_slot,
    element_state,
    field_leaves,
    init_state,
    knobs_from_config,
    stack_states,
)

_i32 = torch.int32


def idle_trace(n_cores: int) -> Trace:
    """The empty workload: every core's trace is a single END event, so
    the element is done before its first step."""
    events = np.zeros((n_cores, 1, 4), np.int32)
    events[:, :, 0] = EV_END
    return Trace(events, np.ones(n_cores, np.int32))


def _trace_per_step_bound(cfg: MachineConfig, trace: Trace) -> int:
    """Worst-case per-step instruction-counter increment for one trace
    (the Engine/FleetEngine accumulator-overflow bound)."""
    per_ev = max(
        1,
        int(trace.events[:, :, 1].max(initial=0)),
        int(trace.events[:, :, 3].max(initial=0)) + 1,
    )
    return (cfg.local_run_len + 1) * per_ev


#: Override keys `apply_overrides` accepts: the TimingKnobs fields, named
#: as a user would write them in a sweep spec, plus `fault_seed` (it seeds
#: the fault state, data like the knobs).
KNOB_KEYS = (
    "quantum",
    "cpi",
    "l1_lat",
    "llc_lat",
    "link_lat",
    "router_lat",
    "dram_lat",
    "dram_service",
    "contention_lat",
    "prefetch_degree",
    "prefetch_lat",
    "fault_seed",
)


def apply_overrides(cfg: MachineConfig, ov: dict | None) -> MachineConfig:
    """A copy of `cfg` with the timing overrides `ov` applied: the
    element's EFFECTIVE config (a solo Engine on it reproduces the fleet
    element exactly). Keys are KNOB_KEYS; `cpi` takes an int (homogeneous)
    or a length-n_cores sequence. Validation runs via the dataclass
    constructors, plus the conflict-key packing bound on quantum."""
    ov = dict(ov or {})
    unknown = sorted(set(ov) - set(KNOB_KEYS))
    if unknown:
        raise ValueError(
            f"unknown timing override(s) {unknown}; valid keys: {KNOB_KEYS}"
        )
    out = cfg
    if "quantum" in ov:
        out = dataclasses.replace(out, quantum=int(ov["quantum"]))
    if "cpi" in ov:
        v = ov["cpi"]
        if isinstance(v, (int, np.integer)):
            core = dataclasses.replace(
                out.core, cpi=int(v), cpi_per_core=None, cpi_pattern=None
            )
        else:
            core = dataclasses.replace(
                out.core,
                cpi_per_core=tuple(int(x) for x in v),
                cpi_pattern=None,
            )
        out = dataclasses.replace(out, core=core)
    if "l1_lat" in ov:
        out = dataclasses.replace(
            out, l1=dataclasses.replace(out.l1, latency=int(ov["l1_lat"]))
        )
    if "llc_lat" in ov:
        out = dataclasses.replace(
            out, llc=dataclasses.replace(out.llc, latency=int(ov["llc_lat"]))
        )
    noc_kw = {
        k: int(ov[k])
        for k in ("link_lat", "router_lat", "contention_lat")
        if k in ov
    }
    if noc_kw:
        out = dataclasses.replace(
            out, noc=dataclasses.replace(out.noc, **noc_kw)
        )
    if "dram_lat" in ov:
        out = dataclasses.replace(out, dram_lat=int(ov["dram_lat"]))
    if "dram_service" in ov:
        out = dataclasses.replace(out, dram_service=int(ov["dram_service"]))
    if "prefetch_degree" in ov:
        out = dataclasses.replace(
            out, prefetch_degree=int(ov["prefetch_degree"])
        )
    if "prefetch_lat" in ov:
        out = dataclasses.replace(out, prefetch_lat=int(ov["prefetch_lat"]))
    if "fault_seed" in ov:
        out = dataclasses.replace(out, fault_seed=int(ov["fault_seed"]))
    if out.quantum * out.n_cores >= 2**31:
        raise ValueError(
            "quantum * n_cores must be < 2^31 (conflict-key packing); "
            f"got {out.quantum} * {out.n_cores}"
        )
    return out


class FleetEngine:
    """Host runner for a batch of independent simulations on one geometry,
    with the JAX `FleetEngine`'s interface for one device.

    Elements may differ in TRACE and in the timing knobs (per-element
    `overrides` dicts, see KNOB_KEYS); everything else, geometry and
    model selectors, comes from the shared `cfg`. `cycles` is [B, C],
    `counters` maps name -> [B, C], and `element_state`/`element_counters`
    slice out solo-shaped views. The fleet runs on `cuda` unless `device`
    names another."""

    def __init__(
        self,
        cfg: MachineConfig,
        traces: list[Trace],
        overrides: list[dict] | None = None,
        chunk_steps: int = 256,
        device=None,
        min_events_capacity: int = 0,
        force_sync: bool = False,
        mesh=None,
    ):
        if cfg.pallas_reduce:
            raise ValueError(
                "FleetEngine does not support pallas_reduce configs: the "
                "Pallas reduction kernel takes link/router latencies as "
                "static kernel parameters, which defeats the fleet's "
                "traced-knob compilation sharing"
            )
        traces = list(traces)
        if not traces:
            raise ValueError("FleetEngine needs at least one trace")
        if overrides is None:
            overrides = [{}] * len(traces)
        overrides = list(overrides)
        if len(overrides) != len(traces):
            raise ValueError(
                f"got {len(traces)} traces but {len(overrides)} override "
                "dicts (must match 1:1)"
            )
        check_port_supported(cfg)
        # on a tile mesh the lead device holds the replicated fields
        self.device = resolve_device(device) if mesh is None else mesh.lead
        self.mesh = mesh
        B = len(traces)
        C = cfg.n_cores
        self.cfg = cfg
        # effective per-element configs (a solo Engine on elem_cfgs[i] +
        # traces[i] reproduces element i bit-exactly); building them also
        # validates every override combination
        self.elem_cfgs = [apply_overrides(cfg, ov) for ov in overrides]
        # what the step reads of a config: geometry and model selectors
        self.geom_cfg = cfg.timing_normalized()
        self.traces = traces
        has_sync = False
        for t in traces:
            if t.n_cores != C:
                raise ValueError(f"trace has {t.n_cores} cores, config {C}")
            validate_sync(t, cfg.barrier_slots)
            ty = t.events[:, :, 0]
            has_sync = has_sync or bool(
                ((ty == EV_LOCK) | (ty == EV_UNLOCK) | (ty == EV_BARRIER)).any()
            )
        # shared: ANY element with sync events turns phase 2.7 on for the
        # whole fleet (a no-op for the others); `force_sync` pins it on so
        # a serving fleet's launches never depend on its occupants
        self.has_sync = has_sync or force_sync
        # events: per-element line-event arrays END-padded to a common T
        # and stacked [B, C, T, 4] (the engines clamp ptr to T-1);
        # `min_events_capacity` reserves room for traces spliced in later
        # (replace_element). The host copy stays: splices edit it
        T = max(max(t.max_len for t in traces), int(min_events_capacity))
        evs = np.zeros((B, C, T, 4), np.int32)
        evs[:, :, :, 0] = EV_END
        for i, t in enumerate(traces):
            e = np.asarray(t.line_events(cfg.line_bits))
            evs[i, :, : e.shape[1]] = e
        self._events_np = evs
        self._dirty: set[int] = set()  # rows spliced since the last upload
        self.events = torch.from_numpy(evs).to(self.device)
        # same per-chunk counter-accumulator bound as Engine, over the
        # worst event of ANY element
        per_step = max(_trace_per_step_bound(cfg, t) for t in traces)
        if chunk_steps * per_step >= 1 << _ACC_BITS:
            raise ValueError(
                f"chunk_steps={chunk_steps} x max per-step instruction "
                f"increment {per_step} overflows the 2^{_ACC_BITS} "
                "per-chunk counter accumulator; lower chunk_steps or split "
                "large INS batches"
            )
        # each element's solo init state (knobs and quantum_end from its
        # effective config), copied into the batch one at a time
        self.state = stack_states(
            (init_state(c, self.device) for c in self.elem_cfgs), B
        )
        if mesh is not None:
            self._reshard()
        # built and uploaded here, before any step, under the device name
        # the step looks them up by (`cuda:0`, not `cuda`)
        for d in _devices(self.events):
            if cfg.sharer_group > 1:
                group_tables(self.geom_cfg, d)
        if cfg.faults_enabled:
            inject.detour_table(self.geom_cfg, self.state.faults.link_dead.device)
        self.chunk_steps = chunk_steps
        self.cycle_base = np.zeros(B, np.int64)
        self.host_counters = {k: np.zeros((B, C), np.int64) for k in COUNTER_NAMES}
        self.steps_run = np.zeros(B, np.int64)
        # original (caller-side) index of each batch position; the fault
        # isolation builder (sim.supervisor.build_fleet_isolated) rewrites
        # this after quarantining elements so reports keep caller indices
        self.element_ids = list(range(B))
        self.element_overrides = [dict(ov) for ov in overrides]
        # telemetry sink (obs.Recorder): None records nothing
        self.obs = None
        self.obs_label = "fleet"
        # prefix-fork provenance (checkpoint format 6 on): steps of shared
        # prefix each element was forked from, and the warm-cache key the
        # prefix was saved or loaded under (None: ran from step 0)
        self.prefix_steps = np.zeros(B, np.int64)
        self.prefix_cache_keys: list = [None] * B
        # attestation chains (attest.FleetAttest): None hashes nothing
        self.attest = None
        self._stepped = None  # the state the last chunk left (see _host)
        self._drained = None  # a state whose device counters are zero
        # overlapped dispatch (engine.Prefetch): the next chunk speculated
        # from the committed state, adopted only if that is still the state
        self.overlap = False
        self._pending = None
        self._side = None  # the speculation's CUDA stream, made at its first use

    def _reshard(self) -> None:
        """Lay the events and the state out over `self.mesh` (shard x
        vmap: the batch axis whole, cores and banks sharded within each
        element), or bring them whole onto `self.device` when it is None;
        from either form."""
        from ..parallel import sharding

        if self.mesh is None:
            if isinstance(self.events, Shards):
                self.events = self.events.mesh.exchange.full(self.events, self.device)
            self.state = sharding.unshard_state(self.state, self.device)
        else:
            self.events = sharding.shard_fleet_events(self.mesh, self.events)
            self.state = sharding.shard_fleet_state(self.mesh, self.state)
        self._stepped = self._drained = None

    @property
    def n_elements(self) -> int:
        return len(self.traces)

    # ---- host bookkeeping ------------------------------------------------

    def _host(self):
        """(live [B] bool, host step numbers [B]) of the current state.
        Kept from the last chunk's transfer; re-read in ONE transfer (with
        a faulted fleet's schedules) only when the state is not the one
        that chunk left: at the start, after a checkpoint was loaded, or
        after slot surgery wrote rows in place."""
        if self.state is not self._stepped:
            live = not_done(self.cfg, self.events, self.state).any(-1)
            fs, keys = self.state.faults, ()
            if self.cfg.faults_enabled:
                keys = ("seed", "ev_step", "ev_kind", "flip_l1", "due_rate")
            host = to_host([live, self.state.step, *(getattr(fs, k) for k in keys)])
            self._live = host[0].copy()
            self._live_dev = live.to(_i32)
            self._host_step = host[1].astype(np.int64)
            self._fs_host = [
                {k: a[i].copy() for k, a in zip(keys, host[2:])}
                for i in range(self.n_elements)
            ] if keys else None
            self._stepped = self.state
        return self._live, self._host_step

    def _scrub_offsets(self, stepping: np.ndarray) -> set[int] | None:
        """Offsets in the next chunk of the steps on which a core of some
        stepping element can die: the union over those elements (None
        without faults)."""
        if not self.cfg.faults_enabled:
            return None
        out: set[int] = set()
        for i in np.flatnonzero(stepping):
            h = int(self._host_step[i])
            steps = np.arange(h, h + self.chunk_steps)
            out |= set(np.flatnonzero(
                inject.kill_possible(self.cfg, self._fs_host[i], steps)).tolist())
        return out

    def _drain(self) -> None:
        """Fold the device counters into the host's. Free after a chunk
        (its drain zeroed them on the card): no transfer then."""
        if self.state is self._drained:
            return
        cnt = self.state.counters.cpu().numpy()  # [B, n_counters, C]
        for i, k in enumerate(COUNTER_NAMES):
            self.host_counters[k] += cnt[:, i].astype(np.int64)
        kept = self.state is self._stepped  # a drain moves no clock or pointer
        self.state = self.state._replace(counters=_zeros_like(self.state.counters))
        if kept:
            self._stepped = self.state
        self._drained = self.state

    def _event_types_at_ptr(self) -> np.ndarray:
        """[B, C] event type codes under each element's trace pointer
        (END padding included)."""
        return event_types(self.events, self.state.ptr).cpu().numpy()

    def _dead_mask(self) -> np.ndarray:
        """[B, C] bool: fail-stopped cores (all False with faults off)."""
        if self.cfg.faults_enabled:
            return self.state.faults.core_dead.cpu().numpy() != 0
        return np.zeros((self.n_elements, self.cfg.n_cores), bool)

    def core_done_mask(self) -> np.ndarray:
        """[B, C] bool: per-element per-core END-or-dead mask."""
        return ~not_done(self.cfg, self.events, self.state).cpu().numpy()

    def done_mask(self) -> np.ndarray:
        """[B] bool: elements every core of which is at END or dead (from
        the last chunk's transfer when the state is the one it left)."""
        return ~self._host()[0]

    def done(self) -> bool:
        return bool(self.done_mask().all())

    def live_mask(self) -> np.ndarray:
        """[B, C] bool: cores bounding each element's quantum window: not
        at END, not frozen at a barrier, not fail-stopped."""
        et = self._event_types_at_ptr()
        frozen = (et == EV_BARRIER) & (self.state.sync_flag.cpu().numpy() != 0)
        return (et != EV_END) & ~frozen & ~self._dead_mask()

    # ---- run -------------------------------------------------------------

    def run(self, max_steps: int = 10_000_000) -> None:
        """Run every element to completion; each element freezes, step
        counter included, at the chunk boundary where it finished (the JAX
        package's one-dispatch `run`)."""
        max_chunks = -(-max_steps // self.chunk_steps)
        live, _ = self._host()
        k = 0
        while live.any() and k < max_chunks:
            live = self._chunk_once(freeze=True)
            k += 1
        if live.any():
            bad = np.flatnonzero(~self.done_mask()).tolist()
            raise RuntimeError(
                f"fleet: max_steps exceeded on element(s) {bad} (deadlock?)"
            )

    def run_steps(self, n_steps: int) -> None:
        """Advance every LIVE element by `n_steps` (whole chunks) without
        the completion check, the checkpointed-run building block. Every
        element steps: a finished element's steps are no-ops but for the
        `step` counter, so its state stays bit-exact while `state.step`
        may run ahead of a solo engine's."""
        target = int(self.steps_run.max()) + n_steps
        live, _ = self._host()
        while int(self.steps_run.max()) < target and live.any():
            live = self._chunk_once()

    def _chunk_once(self, freeze: bool = False) -> np.ndarray:
        """One committed chunk: dispatch, drain counters, rebase clocks,
        with ONE host transfer. `freeze` holds finished elements' step
        counters (`run`); otherwise every element steps (`run_steps`).
        Returns the live flags after the chunk.

        The recorder `obs`, when set, gets the JAX package's three phase
        cuts: "dispatch" is the Python enqueue of the chunk's launches,
        "drain" runs through the one transfer (the device's tail), and
        "rebase" is the host's folding of what it brought."""
        live, host_step = self._host()
        stepping = live if freeze else np.ones_like(live)
        t0 = time.perf_counter()
        cut = []
        pend, self._pending = self._pending, None
        if pend is not None and pend.source is self.state \
                and pend.chunk_steps == self.chunk_steps and pend.key == freeze:
            new, host, live_dev = adopt(pend)
        else:
            drop(pend)
            new, host, live_dev = self._enqueue_chunk(
                self.state, self._scrub_offsets(stepping),
                self._live_dev if freeze else None, cut)
        t1 = cut[0] if cut else time.perf_counter()
        self.state = new
        B = self.n_elements
        host = host.cpu().numpy()
        t2 = time.perf_counter()
        cnt = host[: -2 * B].reshape(B, len(COUNTER_NAMES), -1)
        for i, k in enumerate(COUNTER_NAMES):
            self.host_counters[k] += cnt[:, i].astype(np.int64)
        self.cycle_base += host[-2 * B : -B].astype(np.int64)
        self.steps_run += np.where(live, self.chunk_steps, 0)
        self._host_step = host_step + np.where(stepping, self.chunk_steps, 0)
        self._live = host[-B:] != 0
        self._live_dev = live_dev
        self._stepped = self._drained = self.state
        self._corrupt_hook()
        if self.attest is not None:
            self.attest.observe(self, live)
        if self.overlap and self._live.any():
            self._prefetch_chunk(freeze)
        if self.obs is not None:
            t3 = time.perf_counter()
            self.obs.chunk_committed(
                self.obs_label, self.chunk_steps, t3 - t0, self.host_counters,
                phases={"dispatch": t1 - t0, "drain": t2 - t1, "rebase": t3 - t2},
            )
        return self._live

    def _enqueue_chunk(self, st, scrub_at, live_dev, cut=None):
        """A chunk of the batched state `st` and its drain and rebase,
        enqueued: (the new state, one int32 device tensor of the drained
        counters, the deltas and the live flags, the live flags as int32
        on the device), nothing read by the host. `live_dev` freezes the
        finished elements (`run`); `cut` gets the time the chunk's own
        launches were enqueued."""
        st = run_chunk(
            self.geom_cfg, self.chunk_steps, self.events, st, self.has_sync,
            scrub_at=scrub_at, live=live_dev,
        )
        if cut is not None:
            cut.append(time.perf_counter())
        new, cnt, delta, nd_any = drain_rebase(self.geom_cfg, self.events, st)
        live = nd_any.to(_i32)
        return new, torch.cat([cnt.flatten(), delta, live]), live

    def _prefetch_chunk(self, freeze: bool) -> None:
        """Speculate the next chunk from the committed state on a copy of
        it (the JAX fleet's `_prefetch_chunk`), in the same run mode, with
        the next chunk's scrub steps and live flags."""
        live, _ = self._host()
        scrub_at = self._scrub_offsets(live if freeze else np.ones_like(live))
        live_dev = self._live_dev if freeze else None
        if self._side is None and self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
        self._pending = prefetch(
            self.state, self.chunk_steps, freeze,
            lambda st: self._enqueue_chunk(st, scrub_at, live_dev), self._side,
            keep=(self.events,) if live_dev is None else (self.events, live_dev),
        )

    def discard_prefetch(self) -> None:
        """Drop any speculated chunk (the identity check would reject it
        after state surgery anyway: this frees it)."""
        drop(self._pending)
        self._pending = None

    def warm_exec(self) -> bool:
        """Load, or build, every kernel this fleet's mode launches through
        the active kernel build cache, without running a step (the JAX
        fleet's `warm_exec`: the pool worker calls it at a lease grant and
        a serve bucket at its bring-up, so no build eats into a lease or
        a first job). False when no cache is active or the fleet runs on
        the CPU, where it launches no kernel."""
        from ..kernels import build
        from . import exec_cache

        if exec_cache.active() is None or self.device.type != "cuda":
            return False
        build.libraries(kernels_of(self.geom_cfg))
        return True

    def _corrupt_hook(self) -> None:
        """Silent-corruption site `fleet.counters` (DESIGN.md §24): a flip
        lands after the drain and before the chunk is fingerprinted, so
        the chain honestly covers the corrupted values, as a flaky DIMM
        would. Detection is attestation's cross-execution compare."""
        chaos.corrupt("fleet.counters", self.host_counters)

    def step_chunk(self) -> None:
        """Advance the whole batch by exactly ONE committed chunk (the
        serving tick): every element steps; finished and idle elements'
        steps are no-ops but for their step counters, and their
        `steps_run` stays put."""
        self._chunk_once()

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- results ---------------------------------------------------------

    @property
    def cycles(self) -> np.ndarray:
        """[B, C] absolute core clocks."""
        return self.state.cycles.cpu().numpy().astype(np.int64) + self.cycle_base[:, None]

    @property
    def counters(self) -> dict[str, np.ndarray]:
        """name -> [B, C] int64."""
        self._drain()
        return self.host_counters

    def element_state(self, i: int) -> MachineState:
        """Element i's machine state, solo-shaped (views of the batch)."""
        return element_state(self.state, i)

    def element_counters(self, i: int) -> dict[str, np.ndarray]:
        self._drain()
        return {k: v[i] for k, v in self.host_counters.items()}

    # ---- slot surgery (serve/) and prefix forking -----------------------

    @classmethod
    def make_slots(cls, cfg: MachineConfig, n_slots: int, capacity_events: int,
                   chunk_steps: int = 256, device=None) -> "FleetEngine":
        """An all-idle serving fleet: `n_slots` elements holding the empty
        workload (`idle_trace`), with event rows reserved for traces of up
        to `capacity_events` per core and the sync phase on. Jobs are
        spliced into free slots with `replace_element` and retired with
        `clear_element`; the shapes and the launches never change over
        the fleet's service lifetime."""
        return cls(
            cfg,
            [idle_trace(cfg.n_cores)] * n_slots,
            chunk_steps=chunk_steps,
            device=device,
            min_events_capacity=capacity_events,
            force_sync=True,
        )

    @property
    def events_capacity(self) -> int:
        """Per-core event capacity (the padded T of the event rows): the
        longest trace `replace_element` accepts."""
        return int(self._events_np.shape[2])

    def replace_element(self, i: int, trace: Trace, override: dict | None = None,
                        base_cfg: MachineConfig | None = None,
                        upload: bool = True) -> None:
        """Splice a new (trace, override) workload into batch position `i`
        without touching any other element: rewrite its event row
        (END-padded to the capacity), reset its machine state to
        `init_state` of its effective config, and zero its host
        accumulators. The previous occupant's device counters are drained
        first (free right after a chunk).

        `base_cfg` (default: the fleet's config) admits under a reloaded
        config (e.g. a SIGHUP-refreshed fault schedule); it must share the
        fleet's geometry. `upload=False` defers the row's copy to the card
        so that a tick's splices share one `upload_events()`."""
        self.discard_prefetch()  # the row is rewritten in place below
        ov = dict(override or {})
        ecfg = apply_overrides(base_cfg or self.cfg, ov)
        if ecfg.timing_normalized() != self.geom_cfg:
            raise ValueError(
                "replace_element: effective config does not share this "
                "fleet's compiled geometry"
            )
        if trace.n_cores != self.cfg.n_cores:
            raise ValueError(
                f"trace has {trace.n_cores} cores, config {self.cfg.n_cores}"
            )
        validate_sync(trace, self.cfg.barrier_slots)
        e = np.asarray(trace.line_events(self.cfg.line_bits))
        T = self.events_capacity
        if e.shape[1] > T:
            raise ValueError(
                f"trace needs {e.shape[1]} event slots/core but this "
                f"fleet's capacity is {T}"
            )
        per_step = _trace_per_step_bound(self.cfg, trace)
        if self.chunk_steps * per_step >= 1 << _ACC_BITS:
            raise ValueError(
                f"chunk_steps={self.chunk_steps} x max per-step "
                f"instruction increment {per_step} overflows the "
                f"2^{_ACC_BITS} per-chunk counter accumulator"
            )
        row = self._events_np[i]
        row[:] = 0
        row[:, :, 0] = EV_END
        row[:, : e.shape[1]] = e
        self._dirty.add(i)
        self.traces[i] = trace
        self.elem_cfgs[i] = ecfg
        self.element_overrides[i] = ov
        # flush the previous occupant's device counters before its state
        # row is overwritten (harvest reads host_counters afterwards)
        self._drain()
        for o, x in zip(field_leaves(self.state), field_leaves(init_state(ecfg, self.device))):
            copy_slot(o, i, x)
        self.cycle_base[i] = 0
        self.steps_run[i] = 0
        self.prefix_steps[i] = 0
        self.prefix_cache_keys[i] = None
        for k in self.host_counters:
            self.host_counters[k][i] = 0
        self._stepped = None  # the row changed in place: re-read the host caches
        # a new occupant never inherits the previous job's chain; the
        # owner re-tracks the slot if the new workload is attested
        if self.attest is not None:
            self.attest.drop(i)
        if upload:
            self.upload_events()

    def clear_element(self, i: int, upload: bool = True) -> None:
        """Retire batch position `i` to the idle workload (done at step
        0): the slot stops contributing work and is ready for the next
        `replace_element`."""
        self.replace_element(i, idle_trace(self.cfg.n_cores), upload=upload)

    def upload_events(self) -> None:
        """Copy the event rows spliced since the last call to the card.
        One call covers any number of `upload=False` splices."""
        if self._dirty:
            self.discard_prefetch()
        for i in sorted(self._dirty):
            copy_slot(self.events, i, torch.from_numpy(self._events_np[i]).to(self.device))
        self._dirty.clear()

    def restore_element(self, i: int, snap: dict) -> None:
        """Overlay a solo snapshot into batch position `i`: an element
        checkpoint's (checkpoint.load_element_checkpoint), a prefix run's
        or a warm-cache entry's ({state, cycle_base, steps_run,
        host_counters}): its mid-run machine state and 64-bit host
        accumulators, copied into the slot in place. For a checkpoint,
        call `replace_element(i, trace, override)` with the SAME workload
        first; the resumed element is then bit-exact with one never
        interrupted. The host's cached live flags and step numbers are
        re-read at the next chunk."""
        self.discard_prefetch()
        for o, x in zip(field_leaves(self.state), field_leaves(snap["state"])):
            copy_slot(o, i, x)
        self.cycle_base[i] = snap["cycle_base"]
        self.steps_run[i] = snap["steps_run"]
        for k in COUNTER_NAMES:
            self.host_counters[k][i] = snap["host_counters"][k]
        self._stepped = self._drained = None

    def fork_element(self, i: int, snap: dict, cache_key: str | None = None) -> None:
        """Fork batch position `i` from a shared-prefix snapshot: overlay
        it (restore_element), then RESEED the slot's per-element inputs
        from the element's own effective config: the timing knobs and the
        fault schedule, seed and ECC thresholds. The snapshot's trajectory
        state stays: the dead-core, dead-link and degrade masks record
        events that already fired in the prefix.

        The caller (sim.prefix) guarantees the snapshot's step count is at
        or below the element's divergence point, so the inputs swapped in
        could not have influenced any state the snapshot carries: the
        forked element is bit-exact with an unforked run. Events with step
        < steps_run never re-fire (firing matches the absolute step)."""
        self.discard_prefetch()
        self.restore_element(i, snap)
        ecfg = self.elem_cfgs[i]
        fresh = fault_state_from_config(ecfg, self.device)
        for f in ("seed", "ev_step", "ev_kind", "ev_a", "ev_b",
                  "flip_l1", "flip_llc", "due_rate"):
            getattr(self.state.faults, f)[i].copy_(getattr(fresh, f))
        for o, x in zip(self.state.knobs, knobs_from_config(ecfg, self.device)):
            copy_slot(o, i, x)
        self.prefix_steps[i] = int(snap["steps_run"])
        self.prefix_cache_keys[i] = cache_key

    # ---- checkpoint / resume --------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        from .checkpoint import save_fleet_checkpoint

        save_fleet_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> None:
        from .checkpoint import load_fleet_checkpoint

        self.discard_prefetch()
        load_fleet_checkpoint(path, self)
