"""Calibration tables: published microbenchmark numbers as fit targets,
the JAX package's `calib/table.py` for the port (the same format, checks,
messages and error locations).

A table is a JSON file:

    {
      "name": "ipu_mk1",
      "source": "arXiv:1912.03413",
      "entries": [
        {"name": "tile_stream",
         "generator": "stream", "params": {"n_mem_ops": 128},
         "metric": "cycles_per_mem_op", "observed": 9.5},
        ...
      ]
    }

Each entry names a synthetic workload (`generator` + integer `params`
over trace.synth.GENERATORS — the same namespace as `--synth` specs),
the METRIC the paper measured, and the observed value. The fit minimizes
the sum of squared RELATIVE residuals (sim - obs) / obs over entries.

Kept import-light (no torch): the CLI's typed-error catch imports
`CalibError` on every invocation; the fleet machinery lives in fit.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

#: Metrics an entry may target (computed in fit.py from fleet outputs).
METRIC_NAMES = ("total_cycles", "cycles_per_mem_op")


class CalibError(ValueError):
    """A calibration table is malformed or names unknown generators /
    metrics / fit keys. Typed like ConfigError: the CLI exits 2 with one
    structured `{"error": ...}` JSON line; `entry`/`field` locate the
    offending table row."""

    def __init__(
        self,
        message: str,
        *,
        entry: str | int | None = None,
        field: str | None = None,
    ):
        self.entry = entry
        self.field = field
        where = []
        if entry is not None:
            where.append(f"entry {entry!r}")
        if field is not None:
            where.append(f"field {field!r}")
        prefix = (
            f"calibration table: {', '.join(where)}: " if where
            else "calibration table: "
        )
        super().__init__(prefix + message)

    def location(self) -> dict:
        out = {}
        if self.entry is not None:
            out["entry"] = str(self.entry)
        if self.field is not None:
            out["field"] = self.field
        return out


@dataclass(frozen=True)
class CalibEntry:
    name: str
    generator: str
    params: dict
    metric: str
    observed: float


@dataclass(frozen=True)
class CalibTable:
    name: str
    entries: tuple[CalibEntry, ...]
    source: str = ""
    note: str = ""

    def with_observed(self, values) -> "CalibTable":
        """A copy with each entry's observed value replaced (synthetic
        ground-truth tables for the calibrate self-test)."""
        if len(values) != len(self.entries):
            raise CalibError(
                f"{len(values)} observed values for "
                f"{len(self.entries)} entries"
            )
        ents = tuple(
            CalibEntry(e.name, e.generator, dict(e.params), e.metric, float(v))
            for e, v in zip(self.entries, values)
        )
        return CalibTable(self.name, ents, self.source, self.note)


def _check_entry(i: int, raw) -> CalibEntry:
    from ..trace import synth

    if not isinstance(raw, dict):
        raise CalibError("entry must be an object", entry=i)
    name = raw.get("name")
    if not isinstance(name, str) or not name:
        raise CalibError("missing/empty name", entry=i, field="name")
    gen = raw.get("generator")
    if gen not in synth.GENERATORS:
        raise CalibError(
            f"unknown generator {gen!r} (have: "
            f"{', '.join(sorted(synth.GENERATORS))})",
            entry=name, field="generator",
        )
    params = raw.get("params", {})
    if not isinstance(params, dict):
        raise CalibError("params must be an object", entry=name,
                         field="params")
    for k, v in params.items():
        if not isinstance(v, int) or isinstance(v, bool):
            raise CalibError(
                f"param {k!r} must be an integer (got {v!r})",
                entry=name, field="params",
            )
    metric = raw.get("metric")
    if metric not in METRIC_NAMES:
        raise CalibError(
            f"unknown metric {metric!r} (have: {', '.join(METRIC_NAMES)})",
            entry=name, field="metric",
        )
    obs = raw.get("observed")
    if not isinstance(obs, (int, float)) or isinstance(obs, bool) or obs <= 0:
        raise CalibError(
            f"observed must be a positive number (got {obs!r}) — the fit "
            "minimizes RELATIVE residuals",
            entry=name, field="observed",
        )
    return CalibEntry(name, gen, dict(params), metric, float(obs))


def parse_table(text: str) -> CalibTable:
    try:
        raw = json.loads(text)
    except json.JSONDecodeError as e:
        raise CalibError(f"not valid JSON: {e}") from None
    if not isinstance(raw, dict):
        raise CalibError("top level must be an object")
    name = raw.get("name")
    if not isinstance(name, str) or not name:
        raise CalibError("missing/empty table name", field="name")
    raw_entries = raw.get("entries")
    if not isinstance(raw_entries, list) or not raw_entries:
        raise CalibError("entries must be a non-empty array",
                         field="entries")
    entries = tuple(_check_entry(i, e) for i, e in enumerate(raw_entries))
    seen: set[str] = set()
    for e in entries:
        if e.name in seen:
            raise CalibError("duplicate entry name", entry=e.name)
        seen.add(e.name)
    return CalibTable(
        name, entries,
        source=str(raw.get("source", "")), note=str(raw.get("note", "")),
    )


def load_table(path: str) -> CalibTable:
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise CalibError(f"cannot read {path!r}: {e}") from None
    return parse_table(text)


__all__ = [
    "METRIC_NAMES",
    "CalibEntry",
    "CalibError",
    "CalibTable",
    "load_table",
    "parse_table",
]
