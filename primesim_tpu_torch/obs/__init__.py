"""Telemetry for the port's chunk loop: copies of the JAX package's
`obs/metrics.py`, `obs/trace.py` and `obs/recorder.py`, which import no
JAX but are kept here so the port imports nothing of that package.

All host-side and read-only with respect to the simulated machine (the
device work is untouched, so `--obs off` is bit-exact by construction and
`basic`/`full` only add host bookkeeping at chunk boundaries the engine
already crosses):

- **Metric time-series** (`metrics.MetricStore`): a bounded ring buffer
  of per-chunk samples, counter DELTAS plus wall-clock phase timings,
  dumpable as JSONL.
- **Flight recorder** (`trace.TraceWriter`): Chrome trace-event JSON
  (loads in Perfetto / chrome://tracing) with a span per committed chunk.

`Recorder` is the facade the CLI wires in: one per run, levels
`off|basic|full` (off = no Recorder at all: the engine carries
`obs = None` and skips every telemetry branch). The JAX package's
Prometheus renderer (`obs/prom.py`) is not here: it renders the serve
scheduler and the pool coordinator, which the port does not have yet.
"""

from .metrics import Histogram, MetricStore
from .recorder import LEVELS, Recorder
from .trace import TraceWriter

__all__ = ["Histogram", "LEVELS", "MetricStore", "Recorder", "TraceWriter"]
