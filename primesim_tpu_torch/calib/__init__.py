"""Microbenchmark-driven knob calibration (DESIGN.md §25), the JAX
package's `calib/` for the port.

PriME's breadth came from fitting its abstract timing model to many real
machines; the zoo selectors (topology/coherence/prefetcher) give this
reproduction the model space, and this package closes the loop: load a
published latency/bandwidth table (e.g. the Graphcore IPU
microbenchmarks, arXiv:1912.03413), sweep candidate timing knobs as ONE
fleet per coordinate step — the knobs are per-element data, so every
candidate runs through the same batched step kernels — and report the
best-fit knobs plus per-entry relative residuals.
"""

from .fit import (
    FIT_KEYS_DEFAULT,
    METRICS,
    FitResult,
    fit,
    knob_start,
    simulate_matrix,
    synthesize_observed,
)
from .table import CalibEntry, CalibError, CalibTable, load_table

__all__ = [
    "CalibEntry",
    "CalibError",
    "CalibTable",
    "FIT_KEYS_DEFAULT",
    "FitResult",
    "METRICS",
    "fit",
    "knob_start",
    "load_table",
    "simulate_matrix",
    "synthesize_observed",
]
