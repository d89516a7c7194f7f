"""The port's sharded stream (`ingest/stream.py::StreamEngine(mesh=)`,
`ingest/pipeline.py` on a mesh, `run --stream-window --devices`) against
the JAX package's unsharded StreamEngine, on the CPU.

The shards all live on the CPU here; their count is read from the
suite's 8 XLA_FLAGS devices, as the JAX CLI reads it. The JAX package's
own sharded streams run over GSPMD meshes its suite marks slow, so every
port run here is held to the JAX StreamEngine's UNSHARDED run of the same
seed and machine (once per module): the results do not depend on the
mesh in either package. On 2 and 4 shards the port makes the JAX
StreamEngine's window cuts (the same steps and cursors after every
window, every state field, the cycle base and the host counters at every
cut); a chunk makes one host transfer; a snapshot taken on 4 shards
resumes on 2, unsharded and in the JAX package to the JAX result; a
revocation under a supervised sharded stream is retried (the port's
stream kind never reshards live, as JAX's does not) and the run finishes
to the same result; and the CLI's `--devices` runs, streamed and
pipelined, print `primetpu run`'s summary. Integer simulator: every
tolerance is 0.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

from primesim_tpu.cli import main as jax_main
from primesim_tpu.config.machine import MachineConfig, small_test_config
from primesim_tpu.ingest.stream import StreamEngine as JStream
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import fold_ins
from primesim_tpu_torch import convert
from primesim_tpu_torch.chaos import plan as t_plan
from primesim_tpu_torch.chaos import sites as t_sites
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.ingest.stream import StreamEngine
from primesim_tpu_torch.parallel import sharding
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim.state import Shards
from primesim_tpu_torch.sim.supervisor import RunSupervisor
from primesim_tpu_torch.stats.counters import COUNTER_NAMES

from test_torch_cli import _assert_same_summary, _summary
from test_torch_engine import jax_arrays, port_cfg, port_trace
from test_torch_stream import ROUTER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MACHINES = {
    "folded": (small_test_config(16, n_banks=8, local_run_len=4),
               fold_ins(synth.fft_like(16, n_phases=2, points_per_core=12, seed=85)), 16),
    "router": (ROUTER, fold_ins(synth.fft_like(8, n_phases=2, points_per_core=12, seed=24)), 16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the sharded step runs
    many small operators one shard at a time; see test_torch_sharding)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _healthy_pool():
    yield
    t_sites.deactivate()
    sharding.restore_devices()


def _host(st):
    """A host copy of a state (the port's step writes in place)."""
    if isinstance(st.l1, Shards):
        st = sharding.unshard_state(st, torch.device("cpu"))
    if isinstance(st.cycles, torch.Tensor):
        h = convert.state_to_numpy(st)
    else:
        h = jax_arrays(st)
    return {f: ({k: np.copy(v) for k, v in a.items()} if isinstance(a, dict) else np.copy(a))
            for f, a in h.items()}


def _windows(eng):
    """Run window by window: [(steps, cursor, host state, cycle base,
    host counters)] at every cut."""
    cuts, budget = [], eng._default_budget()
    while True:
        k, finished = eng._advance_window(budget)
        budget -= k
        cuts.append((k, eng.cursor.copy(), _host(eng.state), int(eng.cycle_base),
                     {c: np.asarray(v).copy() for c, v in eng.host_counters.items()}))
        if finished:
            return cuts


@functools.lru_cache(maxsize=None)
def jax_cuts(name):
    """The JAX StreamEngine's unsharded cuts of a machine, once a module."""
    cfg, tr, window = MACHINES[name]
    return _windows(JStream(cfg, tr, window_events=window))


def _port(name, n=None, **kw):
    cfg, tr, window = MACHINES[name]
    mesh = sharding.tile_mesh(n) if n else None
    return StreamEngine(port_cfg(cfg), port_trace(tr), window_events=window,
                        device=None if mesh else "cpu", mesh=mesh, **kw)


def _assert_cuts_equal(tcuts, jcuts):
    assert [(k, c.tolist()) for k, c, *_ in tcuts] == [(k, c.tolist()) for k, c, *_ in jcuts]
    for i, (t, j) in enumerate(zip(tcuts, jcuts)):
        for f in j[2]:
            for k in (j[2][f] if isinstance(j[2][f], dict) else [None]):
                a, b = (t[2][f][k], j[2][f][k]) if k else (t[2][f], j[2][f])
                np.testing.assert_array_equal(a, b, err_msg=f"cut {i} {f} {k}")
        assert t[3] == j[3], f"cut {i} cycle base"
        for c in COUNTER_NAMES:
            np.testing.assert_array_equal(t[4][c], j[4][c], err_msg=f"cut {i} {c}")


def _assert_final(eng, name):
    """A finished port stream equals the JAX StreamEngine's last cut."""
    _, cursor, state, base, counters = jax_cuts(name)[-1]
    np.testing.assert_array_equal(eng.cursor, cursor)
    np.testing.assert_array_equal(eng.cycles, state["cycles"].astype(np.int64) + base)
    for c in COUNTER_NAMES:
        np.testing.assert_array_equal(eng.counters[c], counters[c], err_msg=c)
    t = _host(eng.state)
    for f in state:
        for k in (state[f] if isinstance(state[f], dict) else [None]):
            a, b = (t[f][k], state[f][k]) if k else (t[f], state[f])
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {k}")


@pytest.mark.parametrize("name,n", [("folded", 2), ("folded", 4), ("router", 2)])
def test_sharded_stream_makes_the_jax_stream_engines_cuts(name, n):
    eng = _port(name, n)
    assert isinstance(eng.state.l1, Shards) and len(eng.state.l1) == n
    tcuts = _windows(eng)
    assert isinstance(eng.state.dirm, Shards) and eng.state.dirm.mesh.size == n
    jc = jax_cuts(name)
    assert len(jc) > 2
    _assert_cuts_equal(tcuts, jc)


def test_a_sharded_chunk_makes_one_host_transfer(monkeypatch):
    """On 4 shards every chunk of every window makes exactly one host
    transfer (the counters, the gathered pointers and the delta) and no
    other synchronising call."""
    eng = _port("folded", 4)
    calls = {"chunks": 0, "transfers": 0}
    real_chunk, real_cpu = t_engine.window_chunk, torch.Tensor.cpu

    def chunk(*a, **kw):
        calls["chunks"] += 1
        return real_chunk(*a, **kw)

    def cpu(self, *a, **kw):
        calls["transfers"] += 1
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(t_engine, "window_chunk", chunk)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for sync in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, sync, lambda *a, _s=sync: pytest.fail(_s))
    budget = eng._default_budget()
    while True:
        k, finished = eng._advance_window(budget)
        budget -= k
        if finished:
            break
    monkeypatch.undo()
    assert calls["chunks"] == sum(eng.window_chunks) == calls["transfers"] > len(eng.window_chunks)
    _assert_final(eng, "folded")


def test_a_snapshot_on_4_shards_resumes_on_2_unsharded_and_in_jax(tmp_path):
    from primesim_tpu.sim import checkpoint as j_ck

    eng = _port("folded", 4)
    eng.run_events(int(eng.real_len.sum()) // 2)
    assert not eng.done()
    snap = str(tmp_path / "stream.npz")
    eng.save_checkpoint(snap)
    for n in (2, None):
        r = _port("folded", n)
        r.load_checkpoint(snap)
        assert isinstance(r.state.l1, Shards) == bool(n)
        if n:
            assert r.state.l1.mesh.size == n
        r.run()
        _assert_final(r, "folded")
    cfg, tr, window = MACHINES["folded"]
    j = JStream(cfg, tr, window_events=window)
    j_ck.load_stream_checkpoint(snap, j)
    j.run()
    _, cursor, state, base, counters = jax_cuts("folded")[-1]
    np.testing.assert_array_equal(np.asarray(j.cycles), state["cycles"].astype(np.int64) + base)
    for c in COUNTER_NAMES:
        np.testing.assert_array_equal(np.asarray(j.counters[c]), counters[c], err_msg=c)


def test_a_revocation_under_a_supervised_sharded_stream_is_retried(tmp_path):
    """The supervisor never reshards a stream live (JAX's rule for the
    `stream` kind): a revoked shard id is a device loss it retries, the
    window re-runs on the same mesh, and the result is JAX's."""
    eng = _port("folded", 4)
    sup = RunSupervisor(eng, snapshot_dir=str(tmp_path / "snaps"), checkpoint_every_chunks=1,
                        handle_signals=False, backoff_s=0.01)
    t_sites.install(t_plan.FaultPlan(seed=0, events=(t_plan.FaultEvent(
        site="devices.revoke", occurrence=2, action="revoke", args=(("n", 1),)),)))
    sup.run()
    t_sites.deactivate()
    assert sup.retries == 1 and sup.degrade_rungs == []
    assert eng.state.l1.mesh.size == 4
    assert any("DEVICE_LOST" in ln for ln in sup.log_lines())
    _assert_final(eng, "folded")


# ---- the CLI -------------------------------------------------------------------


@pytest.fixture()
def cfg_path(tmp_path):
    p = str(tmp_path / "m.json")
    with open(p, "w") as f:
        f.write(MachineConfig(n_cores=16, n_banks=16).to_json())
    return p


SPEC = "fft_like:n_phases=2,points_per_core=8"


def test_cli_stream_window_devices_matches_primetpu(cfg_path, capsys):
    """`run --stream-window 16 --devices 4` prints the JAX package's
    unsharded streamed summary, key for key, and the mesh line."""
    args = ["run", cfg_path, "--synth", SPEC, "--fold", "--stream-window", "16"]
    assert jax_main(args) == 0
    j = _summary(capsys.readouterr().out)
    assert main(args + ["--devices", "4", "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "mesh: 4 devices (cpu)" in cap.err
    _assert_same_summary(j, _summary(cap.out))


def test_cli_pipelined_stream_devices_equals_the_jax_stream(cfg_path, tmp_path, capsys):
    """`--ingest-workers 2` on 4 shards: the ingest workers stay host-only
    and the supervised sharded stream retires JAX's unsharded result."""
    args = ["run", cfg_path, "--synth", SPEC, "--stream-window", "16"]
    assert jax_main(args) == 0
    j = _summary(capsys.readouterr().out)
    assert main(args + ["--ingest-workers", "2", "--seg-events", "32", "--devices", "4",
                        "--pool-dir", str(tmp_path / "pool"), "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "mesh: 4 devices (cpu)" in cap.err
    t = _summary(cap.out)
    for k in ("instructions", "max_core_cycles", "noc_msgs"):
        assert t["detail"][k] == j["detail"][k], k
    assert t["detail"]["supervised"] is True


@pytest.mark.slow
def test_rung5_pipelined_sharded_smoke(tmp_path):
    """test_pod_scale.py's rung-5 slice: the 16384-core wafer config on 8
    shards, pipelined ingest, supervised with checkpoints, on a short
    synthetic workload, to the JAX StreamEngine's unsharded result."""
    from primesim_tpu.config.machine import MachineConfig as JCfg
    from primesim_tpu_torch.config.machine import MachineConfig as TCfg
    from primesim_tpu_torch.ingest.pipeline import run_pipelined
    from primesim_tpu_torch.trace import synth as t_synth

    with open(os.path.join(REPO, "configs", "rung5_16384core_wafer.json")) as f:
        text = f.read()
    spec = "fft_like:n_phases=1,points_per_core=2"
    eng, sup, stats = run_pipelined(
        TCfg.from_json(text), t_synth.fft_like(16384, n_phases=1, points_per_core=2),
        synth_spec=spec, window_events=32, ingest_workers=2,
        pool_dir=str(tmp_path / "pool"),
        mesh=sharding.tile_mesh(devices=sharding.visible_devices("cpu")[:8]),
        supervisor_kwargs={"snapshot_dir": str(tmp_path / "ckpt"),
                           "checkpoint_every_chunks": 2},
    )
    assert stats["pool"]["units_done"] == stats["segments"]
    assert sup.committed > 0 and eng.done()
    ref = JStream(JCfg.from_json(text), synth.fft_like(16384, n_phases=1, points_per_core=2),
                  window_events=32)
    ref.run()
    np.testing.assert_array_equal(eng.cycles, np.asarray(ref.cycles))
    for c in COUNTER_NAMES:
        np.testing.assert_array_equal(eng.counters[c], np.asarray(ref.counters[c]), err_msg=c)
