"""The port's solo checkpoints (`sim/checkpoint.py`) against the JAX
package's, on the CPU, mirroring tests/test_checkpoint.py.

The file format is the contract: a snapshot the port writes has the JAX
package's keys and dtypes (the fault state's seed and thresholds as
uint32), and for each machine (an FFT, a lock program, a lock program and
a barrier program multiplexed on a router machine and cut while two cores
wait at a barrier, a fault schedule with seed 0xDEADBEEF above 2^31,
MOESI with the stride prefetcher) three
interrupted runs equal the uninterrupted JAX run in cycles, every counter
and every state field: the port saving and resuming, a JAX snapshot
continued in the port, and a port snapshot continued in JAX. Mismatched
configs, traces and formats and stream, fleet and element snapshots are
refused with the JAX package's messages; a tampered CRC raises
CheckpointCorrupt; a crash before the rename leaves the old snapshot;
after a load the host's scrub trigger follows the loaded step.
Integer simulator: every tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest

from primesim_tpu.config.machine import NocConfig, small_test_config
from primesim_tpu.sim import checkpoint as j_ckpt
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import fold_ins, multiplex
from primesim_tpu_torch.sim import checkpoint as t_ckpt
from primesim_tpu_torch.sim.engine import Engine

from test_torch_engine import assert_engines_equal, jax_arrays, port_cfg, port_trace

CHUNK, CUT = 16, 48  # checkpoints are taken mid-run, after CUT steps

ROUTER = small_test_config(8, n_banks=4, quantum=200, dram_queue=True, dram_service=8,
                           noc=NocConfig(mesh_x=2, mesh_y=4, contention=True,
                                         contention_model="router", contention_lat=2))
CASES = {
    "fft_like": (small_test_config(8, n_banks=4, quantum=200),
                 synth.fft_like(8, n_phases=2, points_per_core=12, seed=41)),
    "lock_contention": (small_test_config(8, n_banks=4, quantum=200),
                        synth.lock_contention(8, n_critical=8, seed=42)),
    "lock_barrier_router": (
        ROUTER,
        fold_ins(multiplex([synth.lock_contention(4, n_critical=6, n_locks=2, seed=42),
                            synth.barrier_phases(4, n_phases=4, work_per_phase=8, seed=43)],
                           line_bits=ROUTER.line_bits))),
    "faults_seed_above_2^31": (
        small_test_config(
            8, n_banks=4, quantum=200, faults_enabled=True, max_fault_events=2,
            fault_seed=0xDEADBEEF, fault_events=((50, 1, 5, 0), (20, 2, 3, 0)),
            fault_flip_l1=0.05, fault_flip_llc=0.05, fault_due_rate=0.3,
            fault_due_failstop=True),
        synth.uniform_random(8, n_mem_ops=96, shared_frac=0.4, seed=3)),
    "moesi_stride": (small_test_config(8, n_banks=4, quantum=200, coherence="moesi",
                                       prefetcher="stride"),
                     synth.stream(8, n_mem_ops=64, seed=4)),
}


@pytest.fixture(scope="module")
def refs():
    """Each case's uninterrupted JAX run, once for the module."""
    out = {}
    for name, (cfg, tr) in CASES.items():
        je = JEngine(cfg, tr, chunk_steps=CHUNK)
        je.run()
        out[name] = je
    return out


def _port(name):
    cfg, tr = CASES[name]
    return Engine(port_cfg(cfg), port_trace(tr), chunk_steps=CHUNK, device="cpu")


def _jax(name):
    cfg, tr = CASES[name]
    return JEngine(cfg, tr, chunk_steps=CHUNK)


def _assert_jax_equal(ref, je, where):
    np.testing.assert_array_equal(je.cycles, ref.cycles, err_msg=f"{where} cycles")
    assert je.steps_run == ref.steps_run
    for k, v in ref.counters.items():
        np.testing.assert_array_equal(je.counters[k], v, err_msg=f"{where} {k}")
    a, b = jax_arrays(ref.state), jax_arrays(je.state)
    for f in a:
        for k in (a[f] if isinstance(a[f], dict) else [None]):
            x, y = (a[f][k], b[f][k]) if k else (a[f], b[f])
            np.testing.assert_array_equal(y, x, err_msg=f"{where} {f} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_port_snapshot_has_the_jax_keys_and_dtypes(tmp_path, name):
    je, te = _jax(name), _port(name)
    je.run_steps(CUT)
    te.run_steps(CUT)
    je.save_checkpoint(str(tmp_path / "j.npz"))
    te.save_checkpoint(str(tmp_path / "t.npz"))
    jz = j_ckpt.load_verified_npz(str(tmp_path / "j.npz"))
    tz = t_ckpt.load_verified_npz(str(tmp_path / "t.npz"))
    assert sorted(tz) == sorted(jz)
    for k in jz:
        assert (tz[k].dtype, tz[k].shape) == (jz[k].dtype, jz[k].shape), k
        if k != "config_json" or name != "faults_seed_above_2^31":
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    assert int(tz["state_faults__seed"]) == int(jz["state_faults__seed"])


@pytest.mark.parametrize("route", ["port->port", "jax->port", "port->jax"])
@pytest.mark.parametrize("name", list(CASES))
def test_resume_equals_the_uninterrupted_jax_run(tmp_path, refs, name, route):
    src, dst = route.split("->")
    a = _port(name) if src == "port" else _jax(name)
    a.run_steps(CUT)
    assert not a.done()  # a mid-run cut
    if name == "lock_barrier_router":  # with barrier arrivals in flight
        assert np.asarray(a.state.barrier_count).any()
    path = str(tmp_path / "mid.npz")
    a.save_checkpoint(path)
    b = _port(name) if dst == "port" else _jax(name)
    b.load_checkpoint(path)
    assert b.steps_run == CUT
    b.run()
    if dst == "port":
        assert_engines_equal(refs[name], b, route)
        b.verify_invariants()
    else:
        _assert_jax_equal(refs[name], b, route)
    if name.startswith("faults"):
        assert int(np.asarray(b.state.faults.seed)) == 0xDEADBEEF
        assert b.counters["core_failstops"].sum() and b.counters["ecc_corrected"].sum()


def _saved(tmp_path, name="fft_like"):
    te = _port(name)
    te.run_steps(CUT)
    path = str(tmp_path / "c.npz")
    te.save_checkpoint(path)
    return te, path


def _refusals_match(path, t_eng, j_eng):
    """Both engines refuse the file with the same exception name and text."""
    with pytest.raises(ValueError) as je:
        j_eng.load_checkpoint(path)
    with pytest.raises(ValueError) as te:
        t_eng.load_checkpoint(path)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)
    return te.value


def test_mismatches_are_refused_with_the_jax_messages(tmp_path):
    _, path = _saved(tmp_path)
    cfg, tr = CASES["fft_like"]
    other_cfg = dataclasses.replace(cfg, quantum=777)
    msg = _refusals_match(
        path, Engine(port_cfg(other_cfg), port_trace(tr), chunk_steps=CHUNK, device="cpu"),
        JEngine(other_cfg, tr, chunk_steps=CHUNK))
    assert "config does not match" in str(msg)
    other_tr = synth.fft_like(8, n_phases=2, points_per_core=12, seed=99)
    msg = _refusals_match(
        path, Engine(port_cfg(cfg), port_trace(other_tr), chunk_steps=CHUNK, device="cpu"),
        JEngine(cfg, other_tr, chunk_steps=CHUNK))
    assert "trace does not match" in str(msg)


@pytest.mark.parametrize("kind", ["format", "stream", "fleet", "element"])
def test_other_formats_and_kinds_are_refused(tmp_path, kind):
    _, path = _saved(tmp_path)
    z = t_ckpt.load_verified_npz(path)
    if kind == "format":
        z["format"] = np.int64(6)
    else:
        z[kind] = np.int64(1)
    bad = str(tmp_path / f"{kind}.npz")
    t_ckpt.atomic_save_npz(bad, **z)
    msg = _refusals_match(bad, _port("fft_like"), _jax("fft_like"))
    assert (kind if kind != "format" else "unsupported checkpoint format 6") in str(msg).lower()


def test_tampered_crc_raises_checkpoint_corrupt(tmp_path):
    _, path = _saved(tmp_path)
    z = dict(np.load(path))
    z["state_cycles"] = z["state_cycles"] + 1  # the manifest keeps the old CRC
    np.savez_compressed(path, **z)
    err = _refusals_match(path, _port("fft_like"), _jax("fft_like"))
    assert isinstance(err, t_ckpt.CheckpointCorrupt) and "fails CRC32" in str(err)
    (tmp_path / "torn.npz").write_bytes(b"not a zip")
    with pytest.raises(t_ckpt.CheckpointCorrupt, match="unreadable checkpoint"):
        _port("fft_like").load_checkpoint(str(tmp_path / "torn.npz"))
    with pytest.raises(FileNotFoundError):
        _port("fft_like").load_checkpoint(str(tmp_path / "missing.npz"))


def test_crash_before_the_rename_keeps_the_old_snapshot(tmp_path, monkeypatch):
    te, path = _saved(tmp_path)
    good = open(path, "rb").read()
    te.run_steps(CHUNK)

    def dies_mid_write(f, **arrays):
        f.write(b"torn partial npz bytes")
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(t_ckpt.np, "savez_compressed", dies_mid_write)
    with pytest.raises(OSError, match="simulated crash"):
        te.save_checkpoint(path)
    monkeypatch.undo()
    assert open(path, "rb").read() == good
    assert [p.name for p in tmp_path.iterdir()] == ["c.npz"]  # no temp litter
    fresh = _port("fft_like")
    fresh.load_checkpoint(path)
    assert fresh.steps_run == CUT


def test_scrub_offsets_follow_the_loaded_step(tmp_path):
    """The host counts steps for the scrub trigger from the state it last
    left; a loaded state's step is re-read, not the counter carried on."""
    name = "faults_seed_above_2^31"
    a = _port(name)
    a.run_steps(CUT)
    path = str(tmp_path / "f.npz")
    a.save_checkpoint(path)
    b = _port(name)
    b.run_steps(2 * CUT)  # its host step counter is at 96
    before = b.scrub_offsets()
    b.load_checkpoint(path)
    after = b.scrub_offsets()
    assert after == a.scrub_offsets()
    assert int(b.state.step) == CUT and b._host_step == CUT
    assert 50 - CUT in after  # the scheduled kill at step 50
    assert before != after
