"""Chrome trace-event flight recorder (a copy of the JAX package's
`obs/trace.py`).

Emits the JSON Object Format (``{"traceEvents": [...]}``) understood by
Perfetto and chrome://tracing. One process (`pid` = os.getpid()), one
synthetic thread per event source — "engine", "supervisor", "scheduler",
"journal", per-bucket fleet labels — named via `ph:"M"` thread_name
metadata so the timeline rows read like the subsystems they are.

Invariants the schema tests (tests/test_obs.py, tests/test_torch_obs.py)
hold us to:

- every event has ``ph``, ``ts``, ``pid``, ``tid``, ``name``
- ``ts`` is non-decreasing per tid
- B/E spans are balanced per tid (we only emit non-nested spans, so
  balanced == alternating B,E,B,E...)

Spans are recorded retroactively: callers time a region themselves and
hand us the duration (`complete()`), so the hot loop pays one
perf_counter call per phase, not a writer call on entry AND exit. To
keep per-tid timestamps monotonic even when a caller's span would
overlap the previous one (clock jitter), the B timestamp is clamped to
the previous span's end on that tid.
"""

from __future__ import annotations

import json
import os
import time


class TraceWriter:
    def __init__(self, max_events: int = 200_000):
        self.t0 = time.perf_counter()
        self.pid = os.getpid()
        self.max_events = int(max_events)
        self.events = []
        self.dropped = 0
        self._tids = {}
        self._last_end_us = {}

    def _now_us(self):
        return (time.perf_counter() - self.t0) * 1e6

    def _tid(self, label):
        tid = self._tids.get(label)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[label] = tid
            self._last_end_us[tid] = 0.0
            # thread_name metadata so Perfetto labels the row
            self.events.append({
                "ph": "M", "ts": 0, "pid": self.pid, "tid": tid,
                "name": "thread_name", "args": {"name": str(label)},
            })
        return tid

    def _push(self, ev):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return False
        self.events.append(ev)
        return True

    def complete(self, label, name, dur_s, args=None):
        """Record a span of ``dur_s`` seconds ending now on ``label``'s row."""
        tid = self._tid(label)
        end = self._now_us()
        begin = max(end - float(dur_s) * 1e6, self._last_end_us[tid])
        if begin > end:  # clamp collapsed the span; keep it zero-width
            begin = end
        b = {"ph": "B", "ts": begin, "pid": self.pid, "tid": tid, "name": str(name)}
        if args:
            b["args"] = dict(args)
        e = {"ph": "E", "ts": end, "pid": self.pid, "tid": tid, "name": str(name)}
        # push pairwise so B/E stay balanced even at the drop boundary
        if len(self.events) + 2 > self.max_events:
            self.dropped += 2
            return
        self.events.append(b)
        self.events.append(e)
        self._last_end_us[tid] = end

    def instant(self, label, name, args=None):
        tid = self._tid(label)
        ts = max(self._now_us(), self._last_end_us[tid])
        ev = {"ph": "i", "ts": ts, "pid": self.pid, "tid": tid,
              "name": str(name), "s": "t"}
        if args:
            ev["args"] = dict(args)
        if self._push(ev):
            self._last_end_us[tid] = ts

    def write(self, path):
        doc = {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
        }
        if self.dropped:
            doc["otherData"] = {"dropped_events": self.dropped}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(self.events)
