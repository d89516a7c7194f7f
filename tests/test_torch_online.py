"""The port's execution-driven capture (`ingest/capture.py`,
`ingest/ring.py`, the `capture` verb) against the JAX package, on the
CPU, mirroring tests/test_frontend.py.

The port's own copy of the capture shim builds into the git-ignored
`_build/` directory and captures the port's copy of `ocean_like` (a
pthread grid relaxation: memcpy traffic, a mutex-protected reduction and
a global barrier per phase; 4 worker threads and the main thread, so 5
cores). The captured trace has the JAX test's structure. `OnlineEngine`
simulates the shim's shared-memory rings while the target runs, through
the same window loop as `StreamEngine`, and equals the port's preloaded
`Engine` on the same captured stream (`RingSource.to_trace()`), which
equals the JAX package's `Engine` on it. The `capture` verb writes a
trace (`--out`) that `run` simulates as `primetpu run` does, and its
online summary has `primetpu capture`'s keys. Skipped where `gcc` or
`g++` is missing, as tests/test_frontend.py is. Integer simulator: every
tolerance is 0.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

from primesim_tpu.cli import main as jax_main
from primesim_tpu.config.machine import CacheConfig, MachineConfig, NocConfig
from primesim_tpu.ingest import ring as j_ring
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace.format import Trace as JTrace
from primesim_tpu_torch import convert
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.ingest import capture, ring
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.stats.counters import COUNTER_NAMES
from primesim_tpu_torch.trace.format import EV_BARRIER, EV_LD, EV_LOCK, EV_ST, EV_UNLOCK

from test_torch_engine import assert_engines_equal, port_cfg

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="native toolchain unavailable",
)

N_THREADS, N_PHASES, ROWS = 4, 1, 2
LINES_PER_ROW = 256 * 8 // 64  # COLS doubles per 64-byte line
CFG = MachineConfig(
    n_cores=N_THREADS + 1, n_banks=4,
    l1=CacheConfig(size=2048, ways=2, line=64, latency=2),
    llc=CacheConfig(size=16384, ways=4, line=64, latency=10),
    noc=NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1),
    dram_lat=100, quantum=10_000,
)
# the preloaded and the streamed runs differ only in epoch- and
# window-relative fields and in the chunk-rounded step counter
RELATIVE = ("ptr", "cycles", "quantum_end", "barrier_time", "step", "link_free", "dram_free")


@pytest.fixture(scope="module")
def ocean_binary(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("frontend") / "ocean_like")
    # -fno-builtin keeps memcpy/memset as libc calls the shim interposes,
    # and -U_FORTIFY_SOURCE keeps them from becoming __memcpy_chk where the
    # compiler fortifies by default
    subprocess.run(
        ["gcc", "-O2", "-fno-builtin", "-U_FORTIFY_SOURCE", "-o", out,
         str(capture.FRONTEND / "examples" / "ocean_like.c"), "-lpthread"],
        check=True, capture_output=True,
    )
    return out


def _cmd(binary, threads=N_THREADS, phases=N_PHASES, rows=ROWS):
    return [binary, str(threads), str(phases), str(rows)]


def test_shim_builds_outside_the_source_directory_once():
    so = capture.build_shim()
    assert so.startswith(str(capture.BUILD_ROOT)) and os.path.exists(so)
    assert not [f for f in os.listdir(capture.FRONTEND) if f.endswith(".so")]
    mtime = os.path.getmtime(so)
    assert capture.build_shim() == so and os.path.getmtime(so) == mtime


def test_capture_structure(ocean_binary):
    t = capture.capture_run(_cmd(ocean_binary), line=64)
    assert t.n_cores == N_THREADS + 1  # workers + main thread (core 0)
    assert t.line_addressed and t.line_bits == 6
    types = t.events[:, :, 0]
    for c in range(1, t.n_cores):  # each worker thread
        row = types[c, : t.lengths[c]]
        assert (row == EV_LOCK).sum() == N_PHASES
        assert (row == EV_UNLOCK).sum() == N_PHASES
        assert (row == EV_BARRIER).sum() == N_PHASES
        assert (row == EV_LD).sum() >= N_PHASES * ROWS * LINES_PER_ROW
        assert (row == EV_ST).sum() >= N_PHASES * ROWS * LINES_PER_ROW
    bar = t.events[:, :, 0] == EV_BARRIER
    assert (t.events[:, :, 1][bar] == N_THREADS).all()
    assert (t.events[:, :, 2][bar] == 0).all()
    lock_addrs = t.events[:, :, 2][t.events[:, :, 0] == EV_LOCK]
    assert len(np.unique(lock_addrs)) == 1
    off = capture.capture_run(_cmd(ocean_binary, 2, 1, 1), capture_memops=False)
    otypes = off.events[:, :, 0]
    assert ((otypes == EV_LD) | (otypes == EV_ST)).sum() == 0
    assert (otypes == EV_BARRIER).sum() == 2  # sync is still captured


def test_online_equals_the_preloaded_port_and_jax_engines(ocean_binary):
    """The target streams through the rings while OnlineEngine simulates
    them; the result equals the preloaded run of this execution's stream
    in the port and in the JAX package."""
    proc, src = capture.capture_online(_cmd(ocean_binary), n_cores=CFG.n_cores, line=64)
    try:
        eng = ring.OnlineEngine(port_cfg(CFG), src, window_events=64, device="cpu")
        eng.run()  # returns when the target finished and every stream drained
        assert proc.wait(timeout=30) == 0
        assert src.dropped() == 0 and int(src.total.sum()) > 0
        trace = src.to_trace()
    finally:
        if proc.poll() is None:
            proc.kill()
        src.close()
    assert len(eng.window_chunks) >= 2
    ref = Engine(port_cfg(CFG), trace, chunk_steps=64, device="cpu")
    ref.run()
    np.testing.assert_array_equal(eng.cycles, ref.cycles)
    for k in COUNTER_NAMES:
        np.testing.assert_array_equal(eng.counters[k], ref.counters[k], err_msg=k)
    t, r = convert.state_to_numpy(eng.state), convert.state_to_numpy(ref.state)
    for f in set(r) - set(RELATIVE):
        for k in (r[f] if isinstance(r[f], dict) else [None]):
            a, b = (t[f][k], r[f][k]) if k else (t[f], r[f])
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {k}")
    assert eng.counters["barrier_waits"].sum() > 0 and eng.counters["lock_acquires"].sum() > 0
    je = JEngine(CFG, JTrace(trace.events, trace.lengths, line_addressed=True,
                             line_bits=trace.line_bits), chunk_steps=64)
    je.run()
    assert_engines_equal(je, ref, "jax")


def test_ring_source_and_online_engine_refusals(tmp_path):
    """A ring file the shim never initialised times out; a ring of the
    wrong core count or line size is refused, as in the JAX package."""
    p = tmp_path / "bad.ptpuring"
    p.write_bytes(b"\0" * 128)
    for mod in (ring, j_ring):
        with pytest.raises(TimeoutError, match="never initialized"):
            mod.RingSource(str(p), 4, timeout_s=0.05)

    class Source:  # the two fields OnlineEngine checks first
        def __init__(self, n_cores, line_bits):
            self.n_cores, self.line_bits = n_cores, line_bits

    for src in (Source(CFG.n_cores, 7), Source(4, 6)):
        with pytest.raises(ValueError) as te:
            ring.OnlineEngine(port_cfg(CFG), src, device="cpu")
        with pytest.raises(ValueError) as je:
            j_ring.OnlineEngine(CFG, src)
        assert str(te.value) == str(je.value)
        assert ("ring n_cores" if src.n_cores == 4 else "128-byte lines") in str(te.value)


def test_capture_verb_out_online_and_refusal(ocean_binary, tmp_path, capsys):
    cfg = str(tmp_path / "m.json")
    with open(cfg, "w") as f:
        f.write(CFG.to_json())
    out = str(tmp_path / "c.ptpu")
    assert main(["capture", cfg, "--out", out, *_cmd(ocean_binary)]) == 0
    assert "wrote" in capsys.readouterr().err
    run = ["run", cfg, "--trace", out]
    assert jax_main(run) == 0
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(run + ["--device", "cpu"]) == 0
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("instructions", "max_core_cycles", "noc_msgs", "n_cores"):
        assert t["detail"][k] == j["detail"][k], k

    with pytest.raises(SystemExit) as je:
        jax_main(["capture", cfg, "--out", out, "--report", "r.txt", ocean_binary])
    with pytest.raises(SystemExit) as te:
        main(["capture", cfg, "--out", out, "--report", "r.txt", ocean_binary])
    assert str(te.value) == str(je.value)

    # online: the summary has primetpu capture's keys (this execution's
    # numbers are its own), the port's device and step count added
    assert main(["capture", cfg, "--window", "64", "--device", "cpu",
                 *_cmd(ocean_binary)]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
    assert set(d) == {"engine", "step_impl", "n_cores", "instructions", "max_core_cycles",
                      "wall_s", "noc_msgs", "events", "target_rc", "device", "steps"}
    assert d["engine"] == "online" and d["target_rc"] == 0
    assert d["events"] > 0 and d["instructions"] > 0 and d["steps"] > 0
