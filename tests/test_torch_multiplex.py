"""The port's multiprogrammed traces (`trace/format.py::multiplex`, the
reference's several-programs-on-one-uncore mode) against the JAX package,
on the CPU, mirroring tests/test_multiplex.py.

`multiplex` gives the JAX function's bytes for byte- and line-addressed
programs and for an explicit `prog_bits`; its address windows, barrier-id
offsets and lock fold hold; it refuses mixed addressing and window
overflow with the same messages. A multiprogrammed run on a small router
machine (4x16 mesh, router contention, the DRAM queue; a lock program and
a barrier program beside an FFT and a reader-writer) equals the JAX
engine, xla and pallas, in cycles, every counter and every state field;
and a repeated-`--trace` CLI run prints `primetpu run`'s summary numbers.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from primesim_tpu.config.machine import NocConfig, small_test_config
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import format as j_format
from primesim_tpu.trace import synth as j_synth
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.trace import format as t_format
from primesim_tpu_torch.trace import synth as t_synth
from primesim_tpu_torch.trace.format import EV_BARRIER, EV_LD, EV_LOCK, EV_ST

from test_torch_engine import assert_engines_equal, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(gens):
    """[(generator, kwargs)] through both packages' synth modules."""
    return ([j_synth.GENERATORS[g](**kw) for g, kw in gens],
            [t_synth.GENERATORS[g](**kw) for g, kw in gens])


def _line(tr, cls):
    return cls(tr.line_events(6), tr.lengths, line_addressed=True, line_bits=6)


@pytest.mark.parametrize("case", ["byte", "line", "prog_bits=3", "line_bits=7"])
def test_multiplex_is_byte_identical(case):
    gens = [("fft_like", dict(n_cores=8, n_phases=2, points_per_core=8, seed=1)),
            ("lock_contention", dict(n_cores=4, n_critical=5, n_locks=3, seed=2)),
            ("barrier_phases", dict(n_cores=4, n_phases=3, seed=3)),
            ("barrier_phases", dict(n_cores=2, n_phases=2, subset=True, seed=4))]
    js, ts = _both(gens)
    kw = {}
    if case == "line":
        js = [_line(t, j_format.Trace) for t in js]
        ts = [_line(t, t_format.Trace) for t in ts]
    elif case == "prog_bits=3":
        kw = {"prog_bits": 3}
    elif case == "line_bits=7":
        kw = {"line_bits": 7}
    j, t = j_format.multiplex(js, **kw), t_format.multiplex(ts, **kw)
    assert t.events.tobytes() == j.events.tobytes()
    assert t.lengths.tobytes() == j.lengths.tobytes()
    assert (t.line_addressed, t.line_bits) == (j.line_addressed, j.line_bits)
    jf, tf = j_format.fold_ins(j), t_format.fold_ins(t)
    assert tf.events.tobytes() == jf.events.tobytes()


def test_address_windows_barrier_offsets_and_lock_fold():
    a = t_synth.false_sharing(4, n_mem_ops=20, seed=1)
    m = t_format.multiplex([a, a])  # the SAME program twice
    assert m.n_cores == 8
    ty = m.events[:, :, 0]
    mem = (ty == EV_LD) | (ty == EV_ST)
    addrs = [set(np.unique(m.events[s, :, 2][mem[s]]).tolist())
             for s in (slice(0, 4), slice(4, 8))]
    assert addrs[0] and addrs[1] and not (addrs[0] & addrs[1])

    b = t_format.multiplex([t_synth.barrier_phases(4, n_phases=2, seed=2),
                            t_synth.barrier_phases(4, n_phases=3, seed=3)])
    bar = b.events[:, :, 0] == EV_BARRIER
    bids = [set(np.unique(b.events[s, :, 2][bar[s]]).tolist())
            for s in (slice(0, 4), slice(4, 8))]
    assert bids == [{0, 1}, {2, 3}]

    cfg = small_test_config(8, n_banks=4)
    lk = t_format.multiplex([t_synth.lock_contention(4, n_critical=8, seed=7),
                             t_synth.lock_contention(4, n_critical=8, seed=8)])
    is_lock = lk.events[:, :, 0] == EV_LOCK
    slots = [set(((np.unique(lk.events[s, :, 2][is_lock[s]]) >> cfg.line_bits)
                  & (cfg.lock_slots - 1)).tolist())
             for s in (slice(0, 4), slice(4, 8))]
    assert slots[0] and slots[1] and not (slots[0] & slots[1])


def _raises_like(fn_j, fn_t):
    with pytest.raises(ValueError) as je:
        fn_j()
    with pytest.raises(ValueError) as te:
        fn_t()
    assert str(te.value) == str(je.value)
    return str(te.value)


def test_mixed_addressing_and_window_overflow_refused():
    def mixed(fmt, synth):
        a = synth.stream(4, n_mem_ops=10, seed=4)
        return lambda: fmt.multiplex([a, _line(a, fmt.Trace)])

    msg = _raises_like(mixed(j_format, j_synth), mixed(t_format, t_synth))
    assert "addressing" in msg

    def overflow(fmt):
        big = fmt.from_event_lists([[(EV_LD, 4, 2**30)]])
        return lambda: fmt.multiplex([big, big], prog_bits=4)

    assert "window" in _raises_like(overflow(j_format), overflow(t_format))
    assert "at least one" in _raises_like(lambda: j_format.multiplex([]),
                                          lambda: t_format.multiplex([]))
    assert "prog_bits" in _raises_like(
        lambda: j_format.multiplex([j_synth.stream(1, n_mem_ops=1)] * 3, prog_bits=1),
        lambda: t_format.multiplex([t_synth.stream(1, n_mem_ops=1)] * 3, prog_bits=1))


def _router_machine(**kw):
    """64 cores on a 4x16 mesh with router contention and the DRAM queue."""
    return small_test_config(
        64, n_banks=16, quantum=400, dram_queue=True, dram_service=8,
        noc=NocConfig(mesh_x=4, mesh_y=16, contention=True,
                      contention_model="router", contention_lat=2), **kw)


MULTIPROG_SMALL = [
    ("fft_like", dict(n_cores=16, n_phases=2, points_per_core=16, ins_per_mem=4, seed=5)),
    ("lock_contention", dict(n_cores=16, n_critical=4, n_locks=2, seed=6)),
    ("barrier_phases", dict(n_cores=16, n_phases=3, work_per_phase=8, seed=7)),
    ("readers_writer", dict(n_cores=16, n_rounds=4, seed=8)),
]


@pytest.fixture(scope="module")
def multiprog_runs():
    """The port's run and the JAX engine's (xla, pallas) of the small
    multiprogrammed router machine, once for the module."""
    js, ts = _both(MULTIPROG_SMALL)
    jcfg = _router_machine()
    jtr = j_format.fold_ins(j_format.multiplex(js, line_bits=jcfg.line_bits))
    ttr = t_format.fold_ins(t_format.multiplex(ts, line_bits=jcfg.line_bits))
    assert ttr.events.tobytes() == jtr.events.tobytes()
    te = Engine(port_cfg(jcfg), ttr, chunk_steps=32, device="cpu")
    assert te.has_sync
    te.run()
    runs = {}
    for impl in ("xla", "pallas"):
        je = JEngine(dataclasses.replace(jcfg, step_impl=impl), jtr, chunk_steps=32)
        je.run()
        runs[impl] = je
    return te, runs


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_multiprogrammed_router_run_matches_jax(multiprog_runs, impl):
    te, runs = multiprog_runs
    assert_engines_equal(runs[impl], te, impl)
    sums = {k: int(te.counters[k].sum()) for k in
            ("lock_acquires", "barrier_waits", "noc_contention_cycles", "dram_queue_cycles")}
    assert all(sums.values()), sums
    te.verify_invariants()


def test_cli_repeated_trace_matches_primetpu_run(tmp_path, capsys):
    from primesim_tpu.cli import main as jax_main

    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(small_test_config(8, n_banks=4).to_json())
    paths = []
    for i, (g, kw) in enumerate((("false_sharing", dict(n_mem_ops=20, seed=9)),
                                 ("lock_contention", dict(n_critical=4, seed=10)))):
        p = tmp_path / f"p{i}.ptpu"
        t_synth.GENERATORS[g](4, **kw).save(str(p))
        paths += ["--trace", str(p)]
    args = ["run", str(cfg_path), *paths, "--fold", "--chunk-steps", "16"]
    assert jax_main(args) == 0
    jd = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
    r = subprocess.run([sys.executable, "-m", "primesim_tpu_torch", *args, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    td = json.loads(r.stdout.strip().splitlines()[-1])["detail"]
    for k in ("step_impl", "n_cores", "instructions", "max_core_cycles", "noc_msgs"):
        assert td[k] == jd[k], k
    assert td["n_cores"] == 8 and td["instructions"] > 0
