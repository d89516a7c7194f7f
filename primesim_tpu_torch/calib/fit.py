"""Coordinate-descent knob fitting over constant-shape fleets: the JAX
package's `calib/fit.py` for the port, on its `FleetEngine`.

The fit is a pattern search (Hooke-Jeeves style) over the integer
timing knobs: each coordinate step evaluates a FIXED-SIZE candidate set
for one knob — {v - step, v - 1, v, v + 1, v + step}, clipped and padded
with v so the count never varies — as a single FleetEngine batch of
B = n_candidates x n_entries elements. Knobs are per-element data in the
fleet's state, so every candidate of a dispatch runs through the same
batched step kernels, one launch of each per fleet step for all B.

Cost is the sum of squared RELATIVE residuals, residual_e =
(sim_e - obs_e) / obs_e — dimensionless, so cycle-count and
cycles-per-op entries mix in one objective. When a knob's winning
candidate is the center (or a +-1 refinement), its step halves; the
search stops when a full round moves nothing and every step is 1.

The simulator is integer-only, so the metrics, residuals and costs are
the JAX package's to the last bit: each is computed from Python ints in
the JAX code's order. The fleet runs on the evaluator's device (`cuda`
unless `device` names another: `fit`, `simulate_matrix` and
`synthesize_observed` pass theirs through) and brings its clocks and
memory-op counters to the host in one transfer a dispatch.
"""

from __future__ import annotations

import dataclasses as _dc
from dataclasses import dataclass

from .table import METRIC_NAMES, CalibError, CalibTable

#: metric namespace re-export (fit computes them; table validates them)
METRICS = METRIC_NAMES

#: knobs fitted by default — the latency ladder a latency/bandwidth
#: microbenchmark table actually constrains. quantum/contention/
#: prefetch knobs opt in via --fit.
FIT_KEYS_DEFAULT = (
    "cpi", "l1_lat", "llc_lat", "link_lat", "router_lat", "dram_lat",
)

#: every fittable knob -> (reader from MachineConfig, lower bound)
_KNOB_READERS = {
    "quantum": (lambda cfg: cfg.quantum, 1),
    "cpi": (lambda cfg: cfg.core.cpi, 1),
    "l1_lat": (lambda cfg: cfg.l1.latency, 0),
    "llc_lat": (lambda cfg: cfg.llc.latency, 0),
    "link_lat": (lambda cfg: cfg.noc.link_lat, 0),
    "router_lat": (lambda cfg: cfg.noc.router_lat, 0),
    "dram_lat": (lambda cfg: cfg.dram_lat, 0),
    "dram_service": (lambda cfg: cfg.dram_service, 0),
    "contention_lat": (lambda cfg: cfg.noc.contention_lat, 0),
    "prefetch_degree": (lambda cfg: cfg.prefetch_degree, 1),
    "prefetch_lat": (lambda cfg: cfg.prefetch_lat, 0),
}

#: retired memory ops, per the counter taxonomy: every op lands in
#: exactly one of these five buckets
_MEM_OP_COUNTERS = (
    "l1_read_hits", "l1_read_misses", "l1_write_hits", "l1_write_misses",
    "upgrades",
)

N_CANDIDATES = 5


@dataclass(frozen=True)
class FitResult:
    knobs: dict  # best-fit {knob: int}
    start: dict  # where the search started
    cost: float  # sum of squared relative residuals at `knobs`
    residuals: tuple  # per-entry (name, simulated, observed, residual)
    rounds: int  # coordinate-descent rounds executed
    fleet_runs: int  # fleet dispatches
    batch: int  # constant fleet batch size per dispatch

    def report(self) -> dict:
        return {
            "knobs": dict(self.knobs),
            "start": dict(self.start),
            "cost": self.cost,
            "rounds": self.rounds,
            "fleet_runs": self.fleet_runs,
            "batch": self.batch,
            "residuals": [
                {
                    "entry": n, "simulated": s, "observed": o,
                    "residual": r,
                }
                for n, s, o, r in self.residuals
            ],
        }


def check_fit_keys(keys) -> tuple:
    keys = tuple(keys)
    if not keys:
        raise CalibError("no fit keys given", field="fit")
    for k in keys:
        if k not in _KNOB_READERS:
            raise CalibError(
                f"unknown fit knob {k!r} (have: "
                f"{', '.join(sorted(_KNOB_READERS))})",
                field="fit",
            )
    return keys


def knob_start(cfg, keys) -> dict:
    """The search's starting point: the config's own knob values."""
    if "cpi" in keys and (
        cfg.core.cpi_per_core is not None or cfg.core.cpi_pattern is not None
    ):
        raise CalibError(
            "cannot fit 'cpi' on a heterogeneous-cpi config "
            "(cpi_per_core/cpi_pattern set)",
            field="fit",
        )
    return {k: int(_KNOB_READERS[k][0](cfg)) for k in keys}


def build_traces(cfg, table: CalibTable) -> list:
    """One synthetic trace per table entry (built once; every fleet
    dispatch reuses them, keeping the padded event geometry constant)."""
    from ..trace import synth

    traces = []
    for e in table.entries:
        try:
            traces.append(synth.GENERATORS[e.generator](cfg.n_cores,
                                                        **e.params))
        except TypeError as exc:
            raise CalibError(
                f"generator {e.generator!r} rejected params: {exc}",
                entry=e.name, field="params",
            ) from None
    return traces


class _FleetEvaluator:
    """Runs knob-candidate sets against the entry traces as one fleet.

    The batch layout is candidate-major: element k * E + e simulates
    entry e under candidate knob set k. The candidate COUNT is fixed by
    the caller, so B = K * E never changes and neither does the padded
    trace geometry. `runs` counts dispatches, `steps` the fleet steps
    they took (each launches every step kernel once for all B) and
    `instructions` the instructions their elements retired.
    """

    def __init__(self, cfg, table: CalibTable, traces, chunk_steps=256,
                 device=None):
        from ..sim.engine import resolve_device

        self.cfg = cfg
        self.table = table
        self.traces = traces
        self.chunk_steps = chunk_steps
        self.device = resolve_device(device)
        self.runs = 0
        self.steps = 0
        self.instructions = 0

    def __call__(self, knob_sets):
        """[K knob dicts] -> list of K per-entry metric-value lists."""
        from ..sim.fleet import FleetEngine

        E = len(self.table.entries)
        K = len(knob_sets)
        fleet = FleetEngine(
            self.cfg,
            list(self.traces) * K,
            [dict(ks) for ks in knob_sets for _ in range(E)],
            chunk_steps=self.chunk_steps,
            device=self.device,
        )
        fleet.run()
        self.runs += 1
        self.steps += int(fleet.steps_run.max())
        # the clocks' one transfer; the counters were drained by the run
        cycles = fleet.cycles  # [B, C] int64
        counters = fleet.counters
        self.instructions += int(counters["instructions"].sum())
        mem_ops = sum(counters[n] for n in _MEM_OP_COUNTERS).sum(axis=1)
        total = cycles.max(axis=1)  # [B]
        out = []
        for k in range(K):
            row = []
            for e, ent in enumerate(self.table.entries):
                b = k * E + e
                if ent.metric == "total_cycles":
                    row.append(float(total[b]))
                else:  # cycles_per_mem_op: makespan / MEAN per-core ops
                    ops = int(mem_ops[b])
                    if ops == 0:
                        raise CalibError(
                            "trace retired no memory ops — "
                            "cycles_per_mem_op is undefined",
                            entry=ent.name, field="metric",
                        )
                    row.append(
                        float(total[b]) * self.cfg.n_cores / ops
                    )
            out.append(row)
        return out


def _cost(sims, table: CalibTable) -> float:
    return sum(
        ((s - e.observed) / e.observed) ** 2
        for s, e in zip(sims, table.entries)
    )


def _candidates(v: int, step: int, lo: int) -> list[int]:
    """Exactly N_CANDIDATES values: coarse +-step probes and +-1
    refinements around v, clipped to lo and PADDED with v (duplicates
    simulate redundantly but keep the batch size constant)."""
    cand = [max(lo, v - step), max(lo, v - 1), v, v + 1, v + step]
    assert len(cand) == N_CANDIDATES
    return cand


def fit(
    cfg,
    table: CalibTable,
    fit_keys=FIT_KEYS_DEFAULT,
    max_rounds: int = 24,
    chunk_steps: int = 256,
    log=None,
    device=None,
    evaluator=None,
) -> FitResult:
    """Fit `fit_keys` to the table's observed values by per-knob pattern
    search; every dispatch is a constant-shape fleet on `device`.
    `evaluator`, when given, is the `_FleetEvaluator` to dispatch through
    (its `runs` and `steps` then count this fit's work)."""
    keys = check_fit_keys(fit_keys)
    base = knob_start(cfg, keys)
    lo = {k: _KNOB_READERS[k][1] for k in keys}
    step = {k: max(1, base[k] // 2) for k in keys}
    ev = evaluator or _FleetEvaluator(
        cfg, table, build_traces(cfg, table), chunk_steps, device)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        moved = False
        for k in keys:
            v = base[k]
            cand = _candidates(v, step[k], lo[k])
            sims = ev([dict(base, **{k: c}) for c in cand])
            costs = [_cost(row, table) for row in sims]
            best = min(range(N_CANDIDATES), key=lambda i: costs[i])
            if cand[best] != v:
                base[k] = cand[best]
                moved = True
            # coarse probe won -> keep striding; center/refinement won
            # -> tighten the bracket
            if cand[best] not in (max(lo[k], v - step[k]), v + step[k]):
                step[k] = max(1, step[k] // 2)
            if log is not None:
                log(
                    f"round {rounds} {k}: {v} -> {base[k]} "
                    f"(cost {costs[best]:.6g}, step {step[k]})"
                )
        if not moved and all(s == 1 for s in step.values()):
            break
    final = ev([base])[0]
    residuals = tuple(
        (e.name, s, e.observed, (s - e.observed) / e.observed)
        for s, e in zip(final, table.entries)
    )
    return FitResult(
        knobs=dict(base),
        start=knob_start(cfg, keys),
        cost=_cost(final, table),
        residuals=residuals,
        rounds=rounds,
        fleet_runs=ev.runs,
        batch=N_CANDIDATES * len(table.entries),
    )


def simulate_matrix(cfg, table: CalibTable, knob_sets, chunk_steps=256,
                    device=None):
    """Metric values for explicit knob sets: [K dicts] -> K x E lists
    (the building block `fit` loops; exposed for tests/bench)."""
    ev = _FleetEvaluator(cfg, table, build_traces(cfg, table), chunk_steps,
                         device)
    return ev([dict(ks) for ks in knob_sets])


def synthesize_observed(cfg, table: CalibTable, truth: dict,
                        chunk_steps=256, device=None) -> CalibTable:
    """The table with observed values REPLACED by simulating at the
    ground-truth knobs `truth` — the calibrate self-test target: a fit
    started elsewhere must recover `truth` with ~zero residual."""
    check_fit_keys(truth.keys())
    sims = simulate_matrix(cfg, table, [truth], chunk_steps, device)[0]
    return table.with_observed(sims)


def apply_fit(cfg, knobs: dict):
    """`cfg` with the fitted knob values written back into the static
    config fields (for `--out` round-tripping into a machine config)."""
    out = cfg
    if "quantum" in knobs:
        out = _dc.replace(out, quantum=int(knobs["quantum"]))
    if "cpi" in knobs:
        out = _dc.replace(
            out, core=_dc.replace(out.core, cpi=int(knobs["cpi"]))
        )
    if "l1_lat" in knobs:
        out = _dc.replace(
            out, l1=_dc.replace(out.l1, latency=int(knobs["l1_lat"]))
        )
    if "llc_lat" in knobs:
        out = _dc.replace(
            out, llc=_dc.replace(out.llc, latency=int(knobs["llc_lat"]))
        )
    noc_kw = {
        k: int(knobs[k])
        for k in ("link_lat", "router_lat", "contention_lat")
        if k in knobs
    }
    if noc_kw:
        out = _dc.replace(out, noc=_dc.replace(out.noc, **noc_kw))
    for k in ("dram_lat", "dram_service", "prefetch_degree",
              "prefetch_lat"):
        if k in knobs:
            out = _dc.replace(out, **{k: int(knobs[k])})
    return out


__all__ = [
    "FIT_KEYS_DEFAULT",
    "METRICS",
    "N_CANDIDATES",
    "FitResult",
    "apply_fit",
    "build_traces",
    "check_fit_keys",
    "fit",
    "knob_start",
    "simulate_matrix",
    "synthesize_observed",
]
