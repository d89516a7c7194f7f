"""The port's pipelined streaming ingest (`ingest/pipeline.py`: segments,
the spool, `PipelineStreamEngine`, `run_pipelined` and `run
--stream-window W --ingest-workers K`) against the JAX package, on the
CPU.

The machines are tests/test_torch_stream.py's. A segment's bytes equal
the JAX package's for several segment sizes and indices (the END padding
past each core's events and past the trace included, a byte-addressed
and a line-addressed trace), and either package reads the other's
segment files. A `PipelineStreamEngine` fed from a spool of segments the
port wrote in-process makes the JAX `StreamEngine`'s cuts: the same
steps and cursors after every window and every state field, the cycle
base and the host counters equal at every cut. A corrupt segment raises
`CheckpointCorrupt`, a mis-addressed one a ValueError. One `run
--ingest-workers 2` subprocess run, its workers spawned as `python -m
primesim_tpu_torch worker`, equals the JAX package's pipelined run.
Integer simulator: every tolerance is 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from primesim_tpu.cli import main as jax_main
from primesim_tpu.ingest import pipeline as jp
from primesim_tpu.ingest.stream import StreamEngine as JStream
from primesim_tpu.trace.format import Trace
from primesim_tpu_torch.ingest import pipeline as tp
from primesim_tpu_torch.sim.checkpoint import CheckpointCorrupt

from test_torch_cli import _assert_same_summary, _summary
from test_torch_engine import port_cfg, port_trace
from test_torch_stream import MACHINES, _windows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _line_addressed(name):
    cfg, tr = MACHINES[name]
    return cfg, Trace(tr.line_events(cfg.line_bits), tr.lengths,
                      line_addressed=True, line_bits=cfg.line_bits)


@pytest.mark.parametrize("name,line", [("memory", False), ("memory", True),
                                       ("folded", False), ("uneven", False)])
def test_segment_bytes_equal_the_jax_package(tmp_path, name, line):
    cfg, tr = _line_addressed(name) if line else MACHINES[name]
    tcfg, ttr = port_cfg(cfg), port_trace(tr)
    longest = int(np.max(tr.lengths))
    for L in (5, 16, 64):
        for k in range(-(-longest // L) + 1):  # one segment past the end too
            ja, jn = jp.normalize_segment(cfg, tr, k, L)
            ta, tn = tp.normalize_segment(tcfg, ttr, k, L)
            assert ta.dtype == ja.dtype == np.int32 and ta.shape == (cfg.n_cores, L, 4)
            assert ta.tobytes() == ja.tobytes() and tn == jn, (L, k)
    # a file written by one package is read, verified, by the other
    ta, _ = tp.normalize_segment(tcfg, ttr, 1, 16)
    tpath, jpath = tp.segment_path(str(tmp_path / "t"), 1), jp.segment_path(str(tmp_path / "j"), 1)
    assert os.path.relpath(tpath, tmp_path / "t") == os.path.relpath(jpath, tmp_path / "j")
    tp.write_segment(tpath, 1, 16, ta)
    jp.write_segment(jpath, 1, 16, ta)
    assert jp.read_segment(tpath, 1, 16).tobytes() == ta.tobytes()
    assert tp.read_segment(jpath, 1, 16).tobytes() == ta.tobytes()


def test_a_corrupt_or_misaddressed_segment_is_refused(tmp_path):
    cfg, tr = MACHINES["memory"]
    arr, _ = tp.normalize_segment(port_cfg(cfg), port_trace(tr), 0, 16)
    path = tp.segment_path(str(tmp_path), 0)
    tp.write_segment(path, 0, 16, arr)
    with pytest.raises(ValueError, match="segment identity mismatch"):
        tp.read_segment(path, 1, 16)
    with pytest.raises(ValueError, match="segment identity mismatch"):
        tp.read_segment(path, 0, 32)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        tp.read_segment(path, 0, 16)
    # the spool takes an unreadable segment for one not produced yet
    spool = tp.SegmentSpool(str(tmp_path), 16, 1, poll_s=0.01, timeout_s=0.05)
    with pytest.raises(RuntimeError, match="ingest pipeline stalled"):
        spool.acquire(0, 0)
    assert spool.waits == 1


@pytest.mark.parametrize("name,window,seg", [("barrier", 8, 8), ("router", 16, 24),
                                             ("uneven", 5, 12)])
def test_pipelined_engine_makes_the_jax_stream_engines_cuts(tmp_path, name, window, seg):
    cfg, tr = MACHINES[name]
    tcfg, ttr = port_cfg(cfg), port_trace(tr)
    longest = int((np.asarray(tr.lengths) - 1).max())
    n_seg = -(-longest // seg)
    for k in range(n_seg):
        arr, _ = tp.normalize_segment(tcfg, ttr, k, seg)
        tp.write_segment(tp.segment_path(str(tmp_path), k), k, seg, arr)
    spool = tp.SegmentSpool(str(tmp_path), seg, n_seg)
    eng = tp.PipelineStreamEngine(tcfg, ttr, spool, window_events=window, device="cpu")
    tcuts = _windows(eng)
    jcuts = _windows(JStream(cfg, tr, window_events=window))
    assert [(k, c.tolist()) for k, c, *_ in tcuts] == [(k, c.tolist()) for k, c, *_ in jcuts]
    assert len(tcuts) > 2 and spool.waits == 0
    for i, (t, j) in enumerate(zip(tcuts, jcuts)):
        for f in j[2]:
            for k in (j[2][f] if isinstance(j[2][f], dict) else [None]):
                a, b = (t[2][f][k], j[2][f][k]) if k else (t[2][f], j[2][f])
                np.testing.assert_array_equal(a, b, err_msg=f"cut {i} {f} {k}")
        assert t[3] == j[3], f"cut {i} cycle base"
        for c in t[4]:
            np.testing.assert_array_equal(t[4][c], j[4][c], err_msg=f"cut {i} {c}")
    with pytest.raises(ValueError, match="exceeds the ingest segment size"):
        tp.PipelineStreamEngine(tcfg, ttr, spool, window_events=seg + 1, device="cpu")


def test_cli_pipelined_run_equals_the_jax_package(tmp_path, capsys):
    cfg_path = os.path.join(REPO, "configs", "rung1_64core_fft.json")
    args = ["run", cfg_path, "--synth", "fft_like:n_phases=2", "--stream-window", "16",
            "--ingest-workers", "2", "--seg-events", "128"]
    assert jax_main(args + ["--pool-dir", str(tmp_path / "jpool")]) == 0
    jout = capsys.readouterr().out.strip().splitlines()
    r = subprocess.run(
        [sys.executable, "-m", "primesim_tpu_torch", *args, "--device", "cpu",
         "--pool-dir", str(tmp_path / "tpool")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    tout = r.stdout.strip().splitlines()
    _assert_same_summary(_summary(jout[-1]), _summary(tout[-1]))
    jing, ting = json.loads(jout[-2]), json.loads(tout[-2])
    assert ting["metric"] == jing["metric"] == "ingest_pipeline"
    for k in ("segments", "seg_events", "segments_preingested"):
        assert ting["detail"][k] == jing["detail"][k], k
    pool = ting["detail"]["pool"]
    assert pool["units_done"] == pool["units_total"] == ting["detail"]["segments"] > 2


@pytest.mark.parametrize("extra,msg", [
    (["--trace", "m.ptpu", "--fold"], "does not compose with --fold"),
    (["--trace", "a.ptpu", "--trace", "b.ptpu"], "exactly one --trace"),
])
def test_cli_pipelined_refusals_match_primetpu(tmp_path, extra, msg):
    from primesim_tpu_torch.cli import main

    # two 4-core programs multiplex into the 8-core machine
    tr = MACHINES["uneven"][1]
    for p in ("a.ptpu", "b.ptpu"):
        tr.save(str(tmp_path / p))
    MACHINES["memory"][1].save(str(tmp_path / "m.ptpu"))
    cfg_path = str(tmp_path / "cfg.json")
    open(cfg_path, "w").write(MACHINES["memory"][0].to_json())
    args = ["run", cfg_path, "--stream-window", "16", "--ingest-workers", "2",
            *[str(tmp_path / a) if a.endswith(".ptpu") else a for a in extra]]
    for fn in (jax_main, lambda a: main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=msg):
            fn(args)


def test_pipelined_run_without_a_card_spawns_nothing(tmp_path, monkeypatch):
    """Asked for the card with none present, `run_pipelined` raises before
    any ingest worker is spawned."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(tp, "_spawn_ingest_worker", lambda *a: spawned.append(a))
    cfg, tr = MACHINES["memory"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.run_pipelined(port_cfg(cfg), port_trace(tr), synth_spec="false_sharing",
                         window_events=16, pool_dir=str(tmp_path / "pool"))
    assert spawned == []
