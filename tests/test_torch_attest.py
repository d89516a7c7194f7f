"""The port's result attestation (`primesim_tpu_torch/attest/`, the chain
in the engines, the attestation members of checkpoints, the CLI's
`run --attest chain` and its typed-error contract) against the JAX
package, on the CPU, mirroring tests/test_attest.py without the pool.

Every chain head is compared as an exact string with the JAX package's
head of the same run at the same cadence, after every chunk: on a MESI,
a MOESI, a faulted and a router + DRAM queue + O3 machine (8 cores,
chunks of 16), streamed (window-scoped, the cursors in the digest),
supervised through a preemption, a resume and a rolled-back chunk, and
as fleet elements (equal to the solo heads). Solo, stream, fleet and
element checkpoints with chain members resume across the packages both
ways and continue the same chain; attestation off writes snapshots whose
bytes equal an unattested run's, with the JAX package's members. A
`fleet.counters` flip from one FaultPlan gives the same corrupted head in
both packages, and a `checkpoint.payload` flip fails the element loader
of either with AttestationError. The JAX references run once per module.
Integer simulator: every tolerance is 0.
"""

import dataclasses
import functools
import json
import os
import signal
import zipfile

import numpy as np
import pytest

from primesim_tpu import attest as j_at
from primesim_tpu import chaos as j_chaos
from primesim_tpu.cli import main as jax_main
from primesim_tpu.config.machine import (
    FAULT_CORE_FAILSTOP,
    FAULT_LINK_DEGRADE,
    CoreConfig,
    NocConfig,
    small_test_config,
)
from primesim_tpu.ingest.stream import StreamEngine as JStream
from primesim_tpu.sim import checkpoint as j_ck
from primesim_tpu.sim import supervisor as j_sup
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.fleet import FleetEngine as JFleet
from primesim_tpu.trace import synth
from primesim_tpu_torch import attest as t_at
from primesim_tpu_torch import chaos as t_chaos
from primesim_tpu_torch.attest.chain import comparable, heads_equal
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.ingest.stream import StreamEngine
from primesim_tpu_torch.sim import checkpoint as t_ck
from primesim_tpu_torch.sim import supervisor as t_sup
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.sim.fleet import FleetEngine

from test_torch_engine import port_cfg, port_trace

CHUNK = 16
WINDOW = 24


def _cfg(**kw):
    return small_test_config(8, n_banks=4, quantum=200, **kw)


MACHINES = {
    "mesi": _cfg(),
    "moesi": _cfg(coherence="moesi"),
    "faults": dataclasses.replace(
        _cfg(), faults_enabled=True, max_fault_events=2, fault_seed=5,
        fault_events=((40, FAULT_LINK_DEGRADE, 0, 3), (50, FAULT_CORE_FAILSTOP, 3, 0)),
        fault_flip_l1=0.01,
    ),
    # router_cascade's machine: the hop-by-hop router, the DRAM queue, O3
    "router_dram_o3": small_test_config(
        8, n_banks=8, local_run_len=4, dram_queue=True, dram_service=8,
        core=CoreConfig(o3_overlap_256=64),
        noc=NocConfig(mesh_x=2, mesh_y=2, contention=True, contention_model="router",
                      contention_lat=2),
    ),
}


def _trace(seed=41):
    return synth.fft_like(8, n_phases=2, points_per_core=12, seed=seed)


FLEET_OVS = [{}, {"llc_lat": 25}]


def _fleet_trace(i):
    """The fleet's element traces: element 1's is shorter, so it finishes
    chunks before element 0 and steps on idle in the batch."""
    return _trace(41) if i == 0 else synth.fft_like(8, n_phases=1, points_per_core=12, seed=45)


def _recorded(at):
    """Wrap a chain holder's observe so the head after every chunk is kept."""
    heads, observe = [], at.observe

    def rec(*a):
        observe(*a)
        heads.append((at.payload() if hasattr(at, "chain") else None))
    at.observe = rec
    return heads


@functools.lru_cache(maxsize=None)
def jax_heads(name):
    """The JAX Engine's chunked run of a machine with a chain: the payload
    after every chunk."""
    eng = JEngine(MACHINES[name], _trace(), chunk_steps=CHUNK)
    eng.attest = j_at.SoloAttest(CHUNK)
    heads = _recorded(eng.attest)
    eng.run_chunked()
    return heads


def port_engine(name="mesi", chunk=CHUNK):
    eng = Engine(port_cfg(MACHINES[name]), port_trace(_trace()), chunk_steps=chunk,
                 device="cpu")
    eng.attest = t_at.SoloAttest(chunk)
    return eng


@pytest.mark.parametrize("name", MACHINES)
def test_solo_chain_heads_equal_the_jax_heads_after_every_chunk(name):
    eng = port_engine(name)
    heads = _recorded(eng.attest)
    eng.run()
    want = jax_heads(name)
    assert len(heads) > 1 and heads == want
    assert eng.attest.stats["bytes"] > 0


@functools.lru_cache(maxsize=None)
def jax_stream_payload():
    eng = JStream(MACHINES["mesi"], _trace(), window_events=WINDOW)
    eng.attest = j_at.SoloAttest(WINDOW)
    heads = _recorded(eng.attest)
    eng.run()
    return heads


def test_stream_chain_observes_each_window_with_its_cursors():
    eng = StreamEngine(port_cfg(MACHINES["mesi"]), port_trace(_trace()),
                       window_events=WINDOW, device="cpu")
    eng.attest = t_at.SoloAttest(WINDOW)
    heads = _recorded(eng.attest)
    eng.run()
    assert heads == jax_stream_payload()
    # one link per window, never per host chunk of a window
    assert len(heads) < sum(eng.window_chunks)
    assert heads[-1]["chunk_steps"] == WINDOW


def test_supervised_chain_rolls_back_and_resumes_to_the_uninterrupted_head(tmp_path):
    """Preempted at committed chunk 2 (a snapshot with the chain), resumed
    in a fresh engine whose first chunk fails after running: the rollback
    restores the chain with the state, so the retried chunk is linked
    once, and the head equals the JAX package's uninterrupted one."""
    d = str(tmp_path / "ck")

    def preempt(sup):
        if sup.committed == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    eng = port_engine()
    sup = t_sup.RunSupervisor(eng, snapshot_dir=d, checkpoint_every_chunks=1, on_chunk=preempt)
    with pytest.raises(t_sup.Preempted):
        sup.run()
    eng = port_engine()
    sup = t_sup.RunSupervisor(eng, snapshot_dir=d, backoff_s=0.001)
    sup.resume()
    assert eng.attest.payload()["chunks"] == 2
    real, failed = eng.run_steps, []

    def fail_once(n):
        done = real(n)
        if not failed:
            failed.append(eng.steps_run)
            raise RuntimeError("UNAVAILABLE: injected after a real chunk")
        return done

    eng.run_steps = fail_once
    sup.run()
    assert failed and sup.retries == 1
    assert eng.attest.payload() == jax_heads("mesi")[-1]


def test_oom_halving_makes_the_chain_incomparable():
    eng = port_engine()
    real, hit = eng.run_steps, []

    def oom_once(n):
        if not hit:
            hit.append(1)
            raise RuntimeError("CUDA out of memory: injected")
        return real(n)

    eng.run_steps = oom_once
    t_sup.RunSupervisor(eng, handle_signals=False, backoff_s=0.001).run()
    halved = eng.attest.payload()
    assert halved["chunk_steps"] == CHUNK // 2
    assert not comparable(halved, jax_heads("mesi")[-1])


def test_chain_incomparable_after_cadence_change():
    fa = t_at.FleetAttest()
    fa.track(0, 16, start=0)
    fa.note_cadence(8)
    at = {"head": "a" * 64, "chunks": 3, "start": 0, "chunk_steps": 16}
    assert not comparable(fa.payload(0), at)
    assert comparable(at, dict(at, head="b" * 64))
    assert not heads_equal(at, dict(at, head="b" * 64))
    assert heads_equal(at, dict(at))


def _port_fleet(track=True):
    fl = FleetEngine(port_cfg(MACHINES["mesi"]), [port_trace(_fleet_trace(i)) for i in range(2)],
                     FLEET_OVS, chunk_steps=CHUNK, device="cpu")
    if track:
        fl.attest = t_at.FleetAttest()
        for i in range(fl.n_elements):
            fl.attest.track(i, CHUNK)
    return fl


def _jax_fleet(track=True):
    fl = JFleet(MACHINES["mesi"], [_fleet_trace(i) for i in range(2)], FLEET_OVS,
                chunk_steps=CHUNK)
    if track:
        fl.attest = j_at.FleetAttest()
        for i in range(fl.n_elements):
            fl.attest.track(i, CHUNK)
    return fl


@functools.lru_cache(maxsize=None)
def jax_solo_payload(i):
    from primesim_tpu.sim.fleet import apply_overrides

    eng = JEngine(apply_overrides(MACHINES["mesi"], FLEET_OVS[i]), _fleet_trace(i),
                  chunk_steps=CHUNK)
    eng.attest = j_at.SoloAttest(CHUNK)
    eng.run_chunked()
    return eng.attest.payload()


def _solo_payloads():
    return [jax_solo_payload(i) for i in range(2)]


def test_fleet_element_heads_equal_the_solo_heads():
    """Elements finish at different chunks; a finished element keeps
    stepping in the batch, but its chain stops where its solo run's
    loop stops, so every element's head is its solo head."""
    fl = _port_fleet()
    t_sup.RunSupervisor(fl, handle_signals=False).run()
    got = [fl.attest.payload(i) for i in range(fl.n_elements)]
    assert got == _solo_payloads()
    assert got[0]["chunks"] != got[1]["chunks"]


def test_attest_off_changes_no_result():
    def run(on):
        fl = _port_fleet(track=on)
        assert on or fl.attest is None
        t_sup.RunSupervisor(fl, handle_signals=False).run()
        return {k: v.tolist() for k, v in fl.counters.items()}, fl.cycles.tolist()

    assert run(False) == run(True)


def test_chunk_digest_sees_every_committed_field():
    from primesim_tpu_torch.attest.chain import chunk_digest, link, state_leaves

    eng = port_engine()
    eng.run_steps(32)
    leaves = [np.copy(a) for a in state_leaves(eng.state)]
    args = (eng.steps_run, eng.cycle_base)
    base = chunk_digest(*args, eng.host_counters, leaves)
    assert base == chunk_digest(*args, dict(eng.host_counters), list(leaves))
    flip = dict(eng.host_counters, instructions=eng.host_counters["instructions"] + 1)
    assert chunk_digest(*args, flip, leaves) != base
    for i in range(len(leaves)):
        if not leaves[i].size:  # an empty fault-schedule row (no events)
            continue
        bent = list(leaves)
        bent[i] = leaves[i] + 1
        assert chunk_digest(*args, eng.host_counters, bent) != base, i
    assert link("", base) != link("", chunk_digest(*args, flip, leaves))


def test_leaves_are_the_jax_leaves():
    """The digest's leaves have the JAX state's leaf order, dtypes and
    shapes, uint32 fault values included."""
    import jax

    from primesim_tpu_torch.attest.chain import state_leaves

    name = "faults"
    j = JEngine(MACHINES[name], _trace(), chunk_steps=CHUNK)
    j.run_steps(32)
    t = port_engine(name)
    t.run_steps(32)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(j.state)]
    tl = state_leaves(t.state)
    assert [(a.dtype, a.shape) for a in tl] == [(a.dtype, a.shape) for a in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)


# ---- checkpoints -----------------------------------------------------------


def _members(path):
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def test_attest_off_snapshots_are_unchanged(tmp_path, monkeypatch):
    """With no chain the writer adds nothing: a snapshot of an unattested
    run and one of an attested run whose chain is then detached are the
    same bytes (zip timestamps frozen), hold exactly the JAX package's
    attest-off members with its values, and an attested snapshot adds
    exactly the four chain members."""
    monkeypatch.setattr(zipfile.time, "time", lambda: 1.7e9)
    off, on = port_engine(), port_engine()
    off.attest = None
    for eng in (off, on):
        eng.run_steps(32)
    on.save_checkpoint(str(tmp_path / "attested.npz"))
    on.attest = None
    off.save_checkpoint(str(tmp_path / "a.npz"))
    on.save_checkpoint(str(tmp_path / "b.npz"))
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()
    j = JEngine(MACHINES["mesi"], _trace(), chunk_steps=CHUNK)
    j.run_steps(32)
    j.save_checkpoint(str(tmp_path / "j.npz"))
    tm, jm = _members(tmp_path / "a.npz"), _members(tmp_path / "j.npz")
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].dtype == jm[k].dtype and np.array_equal(tm[k], jm[k]), k
    extra = set(_members(tmp_path / "attested.npz")) - set(tm)
    assert extra == {"attest_head", "attest_chunks", "attest_start", "attest_chunk_steps"}


def _jax_solo(attest=True):
    j = JEngine(MACHINES["mesi"], _trace(), chunk_steps=CHUNK)
    if attest:
        j.attest = j_at.SoloAttest(CHUNK)
    return j


def _continue_solo(kind, src, dst, path):
    """Run `src` to a cut, snapshot it, load it into `dst` (the other
    package's engine of the same kind) and finish: dst's final payload."""
    if kind == "solo":
        src.run_steps(32)
        src.save_checkpoint(path)
        dst.load_checkpoint(path)
        assert dst.attest.payload()["chunks"] == 2
        dst.run_chunked() if hasattr(dst, "run_chunked") else dst.run()
    else:
        src.run_events(200)
        src.save_checkpoint(path)
        dst.load_checkpoint(path)
        assert dst.attest.payload() == src.attest.payload()
        dst.run()
    return dst.attest.payload()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["solo", "stream"])
def test_solo_and_stream_snapshots_carry_the_chain_across_packages(kind, direction, tmp_path):
    if kind == "solo":
        j, t, want = _jax_solo(), port_engine(), jax_heads("mesi")[-1]
    else:
        j = JStream(MACHINES["mesi"], _trace(), window_events=WINDOW)
        j.attest = j_at.SoloAttest(WINDOW)
        t = StreamEngine(port_cfg(MACHINES["mesi"]), port_trace(_trace()),
                         window_events=WINDOW, device="cpu")
        t.attest = t_at.SoloAttest(WINDOW)
        want = jax_stream_payload()[-1]
    src, dst = (j, t) if direction == "jax_to_port" else (t, j)
    assert _continue_solo(kind, src, dst, str(tmp_path / "s.npz")) == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fleet_snapshots_carry_the_chains_across_packages(direction, tmp_path):
    j, t = _jax_fleet(), _port_fleet()
    src, dst = (j, t) if direction == "jax_to_port" else (t, j)
    src.run_steps(32)
    path = str(tmp_path / "f.npz")
    src.save_checkpoint(path)
    dst.load_checkpoint(path)
    sup = t_sup if dst is t else j_sup
    sup.RunSupervisor(dst, handle_signals=False).run()
    assert [dst.attest.payload(i) for i in range(2)] == _solo_payloads()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_element_checkpoints_cross_both_ways_with_their_self_digest(direction, tmp_path):
    """An element checkpoint taken at chunk 2 of a fleet slot, loaded by
    the other package, spliced into a fresh fleet and run on: the slot's
    chain continues to the uninterrupted solo head. The self-digest is
    checked on load, over the other package's arrays."""
    from primesim_tpu.sim.fleet import apply_overrides as j_apply
    from primesim_tpu_torch.sim.fleet import apply_overrides as t_apply

    j, t = _jax_fleet(), _port_fleet()
    src, (ld, dst) = ((j, (t_ck, _port_fleet(track=False))) if direction == "jax_to_port"
                      else (t, (j_ck, _jax_fleet(track=False))))
    src.step_chunk()
    src.step_chunk()
    path = str(tmp_path / "e.npz")
    (j_ck if src is j else t_ck).save_element_checkpoint(path, src, 1, job_id="j000002")
    tr = _fleet_trace(1)
    if ld is t_ck:
        cfg, tr = t_apply(port_cfg(MACHINES["mesi"]), FLEET_OVS[1]), port_trace(tr)
        snap = t_ck.load_element_checkpoint(path, cfg, tr)
    else:
        cfg = j_apply(MACHINES["mesi"], FLEET_OVS[1])
        snap = j_ck.load_element_checkpoint(path, cfg, tr)
    at = snap["attest"]
    assert at["chunks"] == 2 and snap["job_id"] == "j000002"
    dst.replace_element(0, tr, FLEET_OVS[1])
    dst.restore_element(0, snap)
    dst.attest = (t_at if ld is t_ck else j_at).FleetAttest()
    dst.attest.track(0, CHUNK, start=at["start"], head=at["head"], chunks=at["chunks"])
    (t_sup if ld is t_ck else j_sup).RunSupervisor(dst, handle_signals=False).run()
    assert dst.attest.payload(0) == _solo_payloads()[1]


def test_solo_loader_refuses_an_element_checkpoint(tmp_path):
    fl = _port_fleet()
    fl.step_chunk()
    path = str(tmp_path / "e.npz")
    t_ck.save_element_checkpoint(path, fl, 0)
    with pytest.raises(ValueError, match="element checkpoint"):
        port_engine().load_checkpoint(path)


# ---- silent corruption: the chaos sites ------------------------------------


def _flip_plan(mod, site, occurrence=2):
    return mod.FaultPlan(seed=0, events=(mod.FaultEvent(
        site, occurrence, "flip", (("delta", 5), ("key", 3), ("pos", 7))),))


def test_fleet_counter_flip_gives_the_same_corrupted_head_in_both_packages():
    heads = {}
    for pkg, (fleet, chaos, sup) in {"jax": (_jax_fleet, j_chaos, j_sup),
                                     "port": (_port_fleet, t_chaos, t_sup)}.items():
        fl = fleet()
        with chaos.active(_flip_plan(chaos, "fleet.counters")) as rt:
            sup.RunSupervisor(fl, handle_signals=False).run()
        assert rt.injected == [{"site": "fleet.counters", "occurrence": 2, "action": "flip"}]
        heads[pkg] = [fl.attest.payload(i) for i in range(2)]
    assert heads["jax"] == heads["port"]
    assert heads["port"] != _solo_payloads()


def test_checkpoint_payload_flip_fails_either_loader(tmp_path):
    """The self-digest is taken before the flip and the write, so the CRC
    manifest passes and the payload check fails, in both packages."""
    fl = _port_fleet()
    fl.step_chunk()
    path = str(tmp_path / "e.npz")
    with t_chaos.active(_flip_plan(t_chaos, "checkpoint.payload", 1)):
        t_ck.save_element_checkpoint(path, fl, 0, job_id="j000001")
    with pytest.raises(t_at.AttestationError) as ei:
        t_ck.load_element_checkpoint(path, fl.elem_cfgs[0], fl.traces[0])
    assert ei.value.location() == {"site": "checkpoint.payload", "unit": "j000001"}
    with pytest.raises(j_at.AttestationError):
        j_ck.load_element_checkpoint(path, MACHINES["mesi"], _fleet_trace(0))


def test_toolchains_of_the_two_packages_never_match():
    ours = t_at.toolchain_fingerprint()
    assert set(ours) == {"torch", "cuda", "backend", "kernels"}
    assert t_at.toolchain_matches(ours, dict(ours)) == ""
    assert t_at.toolchain_matches(ours, j_at.toolchain_fingerprint()) == "torch"
    assert j_at.toolchain_matches(j_at.toolchain_fingerprint(), ours) == "jax"


# ---- the CLI ----------------------------------------------------------------


def _norm(text, *paths):
    for p in paths:
        text = text.replace(str(p), "<DIR>")
    return text


def test_cli_corrupt_snapshot_exits_2_with_the_jax_error_line(tmp_path, capsys):
    """`run --resume` over a directory whose only snapshot is garbage:
    both CLIs exit 2 with the same one-line CheckpointCorrupt JSON."""
    got = {}
    for name, fn in (("jax", jax_main), ("port", main)):
        d = tmp_path / name
        d.mkdir()
        (d / "ckpt-00000001.npz").write_bytes(os.urandom(300))
        args = ["run", "configs/rung1_64core_fft.json", "--synth", "fft_like:n_phases=1",
                "--fold", "--checkpoint-dir", str(d), "--resume"]
        rc = fn(args + (["--device", "cpu"] if name == "port" else []))
        err = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("{")]
        got[name] = (rc, [_norm(ln, d) for ln in err])
    assert got["port"] == got["jax"]
    rc, lines = got["port"]
    assert rc == 2 and len(lines) == 1
    assert json.loads(lines[0])["error"]["type"] == "CheckpointCorrupt"


def _cfg_file(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(MACHINES["mesi"].to_json())
    return str(p)


SPEC = "fft_like:n_phases=2,points_per_core=12,ins_per_mem=4,seed=3"


@pytest.mark.parametrize("mode", ["preloaded", "stream", "supervised"])
def test_cli_run_attest_chain_matches_primetpu(mode, tmp_path, capsys):
    args = ["run", _cfg_file(tmp_path), "--synth", SPEC, "--fold", "--chunk-steps", "16",
            "--attest", "chain"]
    if mode == "stream":
        args += ["--stream-window", str(WINDOW)]
    got = {}
    for name, fn in (("jax", jax_main), ("port", main)):
        extra = []
        if mode == "supervised":
            extra = ["--checkpoint-dir", str(tmp_path / f"ck_{name}"), "--checkpoint-every", "2"]
        if name == "port":
            extra += ["--device", "cpu"]
        assert fn(args + extra) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        got[name] = json.loads(out)["detail"]
    assert got["port"]["attest"] == got["jax"]["attest"]
    assert got["port"]["attest"]["chunks"] > 1
    assert got["port"]["attest"]["chunk_steps"] == (WINDOW if mode == "stream" else 16)
    assert got["port"]["instructions"] == got["jax"]["instructions"]


def test_cli_attest_off_summary_has_no_chain(tmp_path, capsys):
    assert main(["run", _cfg_file(tmp_path), "--synth", SPEC, "--fold", "--device", "cpu"]) == 0
    assert "attest" not in json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
