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
(`sim/prefix.py` runs the prefix). Not ported here: slot surgery for a
serving fleet (`make_slots`, `replace_element`, `clear_element`, and of
`restore_element` more than forking needs), the shard x vmap mesh and
attestation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config.machine import MachineConfig, check_port_supported
from ..faults import inject
from ..faults.schedule import fault_state_from_config
from ..stats.counters import COUNTER_NAMES
from ..trace.format import EV_BARRIER, EV_END, EV_LOCK, EV_UNLOCK, Trace, validate_sync
from .engine import (
    _ACC_BITS,
    _iotas,
    drain_rebase,
    group_tables,
    not_done,
    resolve_device,
    run_chunk,
)
from .state import (
    MachineState,
    element_state,
    init_state,
    knobs_from_config,
    leaves,
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
        self.device = resolve_device(device)
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
        # whole fleet (a no-op for the others)
        self.has_sync = has_sync
        # events: per-element line-event arrays END-padded to a common T
        # and stacked [B, C, T, 4] (the engines clamp ptr to T-1)
        T = max(t.max_len for t in traces)
        evs = np.zeros((B, C, T, 4), np.int32)
        evs[:, :, :, 0] = EV_END
        for i, t in enumerate(traces):
            e = np.asarray(t.line_events(cfg.line_bits))
            evs[i, :, : e.shape[1]] = e
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
        # built and uploaded here, before any step, under the device name
        # the step looks them up by (`cuda:0`, not `cuda`)
        if cfg.sharer_group > 1:
            group_tables(self.geom_cfg, self.events.device)
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
        self._stepped = None  # the state the last chunk left (see _host)

    @property
    def n_elements(self) -> int:
        return len(self.traces)

    # ---- host bookkeeping ------------------------------------------------

    def _host(self):
        """(live [B] bool, host step numbers [B]) of the current state.
        Kept from the last chunk's transfer; re-read (one synchronisation)
        only when the state is not the one that chunk left, e.g. at the
        start or after a checkpoint was loaded."""
        if self.state is not self._stepped:
            self._live = ~self.done_mask()
            self._live_dev = torch.from_numpy(self._live.astype(np.int32)).to(self.device)
            self._host_step = self.state.step.cpu().numpy().astype(np.int64)
            if self.cfg.faults_enabled:
                fs = self.state.faults
                self._fs_host = [
                    {k: getattr(fs, k)[i].cpu().numpy() for k in
                     ("seed", "ev_step", "ev_kind", "flip_l1", "due_rate")}
                    for i in range(self.n_elements)
                ]
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
        cnt = self.state.counters.cpu().numpy()  # [B, n_counters, C]
        for i, k in enumerate(COUNTER_NAMES):
            self.host_counters[k] += cnt[:, i].astype(np.int64)
        kept = self.state is self._stepped  # a drain moves no clock or pointer
        self.state = self.state._replace(counters=torch.zeros_like(self.state.counters))
        if kept:
            self._stepped = self.state

    def _event_types_at_ptr(self) -> np.ndarray:
        """[B, C] event type codes under each element's trace pointer
        (END padding included)."""
        T = self.events.shape[2]
        _, rows_c, ib = _iotas(self.cfg.n_cores, self.n_elements, self.device)
        p = self.state.ptr.clamp(max=T - 1).long()
        return self.events[ib, rows_c, p, 0].cpu().numpy()

    def _dead_mask(self) -> np.ndarray:
        """[B, C] bool: fail-stopped cores (all False with faults off)."""
        if self.cfg.faults_enabled:
            return self.state.faults.core_dead.cpu().numpy() != 0
        return np.zeros((self.n_elements, self.cfg.n_cores), bool)

    def core_done_mask(self) -> np.ndarray:
        """[B, C] bool: per-element per-core END-or-dead mask."""
        return ~not_done(self.cfg, self.events, self.state).cpu().numpy()

    def done_mask(self) -> np.ndarray:
        return self.core_done_mask().all(axis=1)

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
        st = run_chunk(
            self.geom_cfg, self.chunk_steps, self.events, self.state, self.has_sync,
            scrub_at=self._scrub_offsets(stepping),
            live=self._live_dev if freeze else None,
        )
        t1 = time.perf_counter()
        new, cnt, delta, nd_any = drain_rebase(self.geom_cfg, self.events, st)
        self.state = new
        B = self.n_elements
        host = torch.cat([cnt.flatten(), delta, nd_any.to(_i32)]).cpu().numpy()
        t2 = time.perf_counter()
        cnt = host[: -2 * B].reshape(B, len(COUNTER_NAMES), -1)
        for i, k in enumerate(COUNTER_NAMES):
            self.host_counters[k] += cnt[:, i].astype(np.int64)
        self.cycle_base += host[-2 * B : -B].astype(np.int64)
        self.steps_run += np.where(live, self.chunk_steps, 0)
        self._host_step = host_step + np.where(stepping, self.chunk_steps, 0)
        self._live = host[-B:] != 0
        self._live_dev = nd_any.to(_i32)
        self._stepped = self.state
        if self.obs is not None:
            t3 = time.perf_counter()
            self.obs.chunk_committed(
                self.obs_label, self.chunk_steps, t3 - t0, self.host_counters,
                phases={"dispatch": t1 - t0, "drain": t2 - t1, "rebase": t3 - t2},
            )
        return self._live

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

    # ---- prefix forking --------------------------------------------------

    def restore_element(self, i: int, snap: dict) -> None:
        """Overlay a solo snapshot ({state, cycle_base, steps_run,
        host_counters}: a prefix run's, or a warm-cache entry's) into
        batch position `i`: its mid-run machine state and 64-bit host
        accumulators, copied into the slot in place. The host's cached
        live flags and step numbers are re-read at the next chunk."""
        for o, x in zip(leaves(self.state), leaves(snap["state"])):
            o[i].copy_(x)
        self.cycle_base[i] = snap["cycle_base"]
        self.steps_run[i] = snap["steps_run"]
        for k in COUNTER_NAMES:
            self.host_counters[k][i] = snap["host_counters"][k]
        self._stepped = None

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
        self.restore_element(i, snap)
        ecfg = self.elem_cfgs[i]
        fresh = fault_state_from_config(ecfg, self.device)
        for f in ("seed", "ev_step", "ev_kind", "ev_a", "ev_b",
                  "flip_l1", "flip_llc", "due_rate"):
            getattr(self.state.faults, f)[i].copy_(getattr(fresh, f))
        for o, x in zip(self.state.knobs, knobs_from_config(ecfg, self.device)):
            o[i].copy_(x)
        self.prefix_steps[i] = int(snap["steps_run"])
        self.prefix_cache_keys[i] = cache_key

    # ---- checkpoint / resume --------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        from .checkpoint import save_fleet_checkpoint

        save_fleet_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> None:
        from .checkpoint import load_fleet_checkpoint

        load_fleet_checkpoint(path, self)
