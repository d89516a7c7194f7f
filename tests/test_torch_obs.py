"""The port's telemetry (`primesim_tpu_torch/obs/`, `Engine.obs`) against
the JAX package's, on the CPU, mirroring tests/test_obs.py.

The metric ring, the histogram, the Chrome-trace writer (schema-validated:
required fields, per-tid monotonic timestamps, balanced B/E spans) and
the recorder's levels and outputs behave as the JAX copies do on the same
inputs; the report's TIMELINE section renders from the port's recorder;
a recorded chunked run (`--obs basic|full`) is bit-exact with the
unrecorded `run()`; and the port's per-chunk steps and counter deltas
equal the JAX `run_chunked` recorder's, chunk by chunk, on the same run.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from primesim_tpu import obs as j_obs
from primesim_tpu.config.machine import small_test_config
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import fold_ins
from primesim_tpu_torch.obs import Histogram, MetricStore, Recorder, TraceWriter
from primesim_tpu_torch.sim.engine import Engine

from test_torch_engine import port_cfg, port_trace


def _cfg():
    return small_test_config(4)


def _trace(seed=1):
    return fold_ins(synth.fft_like(4, n_phases=1, points_per_core=8, ins_per_mem=4, seed=seed))


def _port_engine(cfg=None, tr=None, chunk_steps=16):
    return Engine(port_cfg(cfg or _cfg()), port_trace(tr or _trace()),
                  chunk_steps=chunk_steps, device="cpu")


def _strip(samples):
    """A store's samples without their host clocks."""
    return [{k: v for k, v in s.items() if k not in ("t", "wall_s", "phases")}
            for s in samples]


# ---- MetricStore and Histogram: the JAX copies' behaviour ---------------


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_metric_store_ring_and_deltas(mod):
    st = (MetricStore if mod == "port" else j_obs.MetricStore)(capacity=3)
    for i in range(5):
        st.record(100.0 + i, "engine", 16, 0.01 * (i + 1),
                  {"instructions": 10 * (i + 1)})
    assert (len(st), st.seq, st.dropped) == (3, 5, 2)
    assert [s["seq"] for s in st.samples()] == [2, 3, 4]
    assert st.samples()[-1]["deltas"]["instructions"] == 50


def test_metric_store_summary_and_jsonl_equal_the_jax_store(tmp_path):
    stores = MetricStore(), j_obs.MetricStore()
    for st in stores:
        st.record(0.0, "engine", 16, 0.001, {"instructions": 1000})  # 1.0 MIPS
        st.record(0.0, "engine", 16, 0.004, {"instructions": 1000}, phases={"drain": 0.003})
    s = stores[0].summary()
    assert s == stores[1].summary()
    assert s["chunks"] == 2 and s["peak_chunk_seq"] == 0 and s["slowest_chunk_seq"] == 1
    assert s["peak_chunk_mips"] == pytest.approx(1.0)
    assert s["mean_chunk_mips"] == pytest.approx(2000 / 0.005 / 1e6)
    assert MetricStore().summary() is None
    paths = [str(tmp_path / f"{i}.jsonl") for i in range(2)]
    assert [st.dump_jsonl(p) for st, p in zip(stores, paths)] == [2, 2]
    assert open(paths[0]).read() == open(paths[1]).read()
    assert json.loads(open(paths[0]).readlines()[1])["phases"]["drain"] == pytest.approx(0.003)


def test_histogram_equals_the_jax_histogram():
    hs = Histogram(bounds=(0.1, 1.0, 10.0)), j_obs.Histogram(bounds=(0.1, 1.0, 10.0))
    for h in hs:
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
    snap = hs[0].snapshot()
    assert snap == hs[1].snapshot()
    assert snap["cumulative"] == [1, 3, 4] and snap["count"] == 5
    assert snap["sum"] == pytest.approx(56.05)
    with pytest.raises(ValueError):
        Histogram(bounds=(1.0, 1.0))


# ---- the trace-event schema ----------------------------------------------


def _validate_trace(events):
    """Required fields on every event, per-tid non-decreasing ts, balanced
    and alternating B/E per tid."""
    assert events, "trace must not be empty"
    last_ts: dict = {}
    open_spans: dict = {}
    for ev in events:
        for field in ("ph", "ts", "pid", "tid", "name"):
            assert field in ev, f"missing {field!r} in {ev}"
        assert ev["ph"] in ("B", "E", "X", "i", "M"), ev
        tid = ev["tid"]
        if ev["ph"] == "M":
            continue
        assert ev["ts"] >= last_ts.get(tid, 0), f"ts went backwards on tid {tid}: {ev}"
        last_ts[tid] = ev["ts"]
        if ev["ph"] == "B":
            assert tid not in open_spans, f"nested B on tid {tid}"
            open_spans[tid] = ev["name"]
        elif ev["ph"] == "E":
            assert open_spans.pop(tid, None) == ev["name"], f"unbalanced E on tid {tid}: {ev}"
    assert not open_spans, f"unclosed spans: {open_spans}"


def _shape(events):
    """A trace's events without clocks and process ids."""
    return [(e["ph"], e["tid"], e["name"], e.get("args")) for e in events]


def test_trace_writer_schema_matches_the_jax_writer(tmp_path):
    writers = TraceWriter(), j_obs.TraceWriter()
    for tw in writers:
        tw.complete("engine", "chunk", 0.01, {"steps": 16})
        tw.instant("supervisor", "checkpoint", {"msg": "ckpt-1"})
        tw.complete("engine", "chunk", 0.02)
        tw.complete("journal", "fsync", 0.001)
        _validate_trace(tw.events)
    assert _shape(writers[0].events) == _shape(writers[1].events)
    names = {e["args"]["name"] for e in writers[0].events if e["ph"] == "M"}
    assert names == {"engine", "supervisor", "journal"}
    p = str(tmp_path / "t.json")
    writers[0].write(p)
    _validate_trace(json.load(open(p))["traceEvents"])


def test_trace_writer_clamps_and_drops():
    tw = TraceWriter()
    tw.complete("engine", "chunk", 1e6)  # would start before the writer was made
    tw.complete("engine", "chunk", 1e6)
    _validate_trace(tw.events)
    assert all(e["ts"] >= 0 for e in tw.events)
    tw = TraceWriter(max_events=3)  # metadata + one B/E pair fills it
    tw.complete("engine", "chunk", 0.01)
    tw.complete("engine", "chunk", 0.01)  # dropped pairwise
    tw.instant("engine", "x")  # dropped
    assert tw.dropped == 3
    _validate_trace(tw.events)


# ---- the recorder and the engine -----------------------------------------


@pytest.mark.parametrize("level", ["basic", "full"])
def test_recorded_chunked_run_is_bit_exact_with_run(level):
    ref = _port_engine()
    assert ref.obs is None  # off: no recorder near the engine
    ref.run()
    rec = Recorder(level)
    eng = _port_engine()
    rec.attach(eng)
    eng.run_chunked()
    np.testing.assert_array_equal(eng.cycles, ref.cycles)
    for k, v in ref.counters.items():
        np.testing.assert_array_equal(eng.counters[k], v, err_msg=k)
    s = rec.store.summary()
    assert s["chunks"] == len(rec.store) == eng.steps_run // 16
    assert s["total_instructions"] == int(ref.counters["instructions"].sum())
    assert all(set(x["phases"]) == {"dispatch", "drain", "rebase"}
               for x in rec.store.samples())
    if level == "full":
        _validate_trace(rec.trace.events)
        spans = [e for e in rec.trace.events if e["ph"] == "B"]
        assert len(spans) == s["chunks"]
        assert all("dispatch_ms" in e["args"] for e in spans)
    else:
        assert rec.trace is None


def test_per_chunk_deltas_equal_the_jax_recorder():
    """Chunk by chunk, the port's recorded steps and counter deltas are
    the JAX run_chunked recorder's on the same run (a lock program on a
    router machine with barriers, so sync counters move too)."""
    from primesim_tpu.config.machine import NocConfig
    from primesim_tpu.trace.format import multiplex

    cfg = small_test_config(16, n_banks=4, quantum=300, noc=NocConfig(
        mesh_x=4, mesh_y=4, contention=True, contention_model="router"))
    tr = fold_ins(multiplex([synth.lock_contention(8, n_critical=4, seed=3),
                             synth.barrier_phases(8, n_phases=3, seed=4)]))
    recs = Recorder("basic"), j_obs.Recorder("basic")
    te = _port_engine(cfg, tr, chunk_steps=8)
    je = JEngine(cfg, tr, chunk_steps=8)
    recs[0].attach(te, label="solo")
    recs[1].attach(je, label="solo")
    te.run_chunked()
    je.run_chunked()
    t, j = _strip(recs[0].store.samples()), _strip(recs[1].store.samples())
    assert len(t) == len(j) > 3
    assert t == j
    assert sum(s["deltas"]["lock_acquires"] for s in t) > 0
    assert sum(s["deltas"]["barrier_waits"] for s in t) > 0


def test_recorder_levels_and_finalize(tmp_path):
    with pytest.raises(ValueError, match="obs level"):
        Recorder("verbose")
    basic = Recorder("basic")
    assert basic.enabled and not basic.tracing and basic.trace is None
    basic.supervisor_event("checkpoint", "noop at basic")  # must not throw
    mp, tp = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    rec = Recorder("full", metrics_path=mp, trace_path=tp)
    eng = _port_engine()
    rec.attach(eng)
    eng.run_chunked()
    rec.supervisor_event("checkpoint", "at the end")
    rec.chaos_event("checkpoint.write", "torn", path="x")
    written = rec.finalize()
    assert written["metrics"][0] == mp and written["trace"][0] == tp
    assert rec.finalize() is written  # idempotent
    events = json.load(open(tp))["traceEvents"]
    _validate_trace(events)
    assert {e["name"] for e in events if e["ph"] == "i"} == {"checkpoint", "checkpoint.write:torn"}
    lines = [json.loads(ln) for ln in open(mp)]
    assert len(lines) == eng.steps_run // 16 and all(x["label"] == "engine" for x in lines)


def test_report_timeline_section():
    from primesim_tpu_torch.stats.report import render_report

    cfg = port_cfg(_cfg())
    rec = Recorder("basic")
    eng = _port_engine()
    rec.attach(eng)
    eng.run_chunked()
    with_tl = render_report(cfg, eng.counters, eng.cycles, wall_s=0.5,
                            timeline=rec.timeline_summary())
    assert "TIMELINE" in with_tl
    assert "peak chunk MIPS" in with_tl and "slowest chunk" in with_tl
    without = render_report(cfg, eng.counters, eng.cycles, wall_s=0.5)
    assert "TIMELINE" not in without
