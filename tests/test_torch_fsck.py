"""The port's `fsck` (`primesim_tpu_torch/analysis/fsck.py`, the `fsck`
verb) against the JAX package's `analysis/fsck.py`, on the CPU, over the
trees of tests/test_analysis.py and tests/test_attest.py.

One parametrised test builds each tree twice (a clean serve journal, a
torn tail, rot in a closed segment, a tampered segment, a missing middle
segment, illegal transitions and a state without an accept, a pool ledger
with conflicting and edited unit keys, a checkpoint with a flipped byte
and one with too few counter rows, warm entries with a disagreeing and
an orphaned sidecar, the JAX package's executable entries clean, rotted,
edited and lowered under another jax, attestation records with malformed,
rewritten and orphaned chain payloads, a unit checkpoint whose chain
contradicts the acked one, and files for `--repair quarantine`). The JAX
package's `run_fsck` checks one copy, the port's the other: their
`render_json` reports are equal but for the root, and so are their
`render_human` texts and what quarantine moved. `run_compare` of each
tree's journal against the clean journal is equal in both packages. The
CLI's exit-2 line on a tampered tree and its exit 0 on a clean one equal
`primetpu`'s. Trees are written by either package's writers: the formats
are one.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zlib
from importlib import metadata

import numpy as np
import pytest

from primesim_tpu.analysis import fsck as JF
from primesim_tpu.config.machine import small_test_config
from primesim_tpu.serve.journal import JobJournal as JJournal
from primesim_tpu_torch.analysis import fsck as TF
from primesim_tpu_torch.analysis.errors import FsckCorrupt
from primesim_tpu_torch.serve.journal import JobJournal, _frame

SYNTH = "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed={}"


def _serve_journal(d, n_jobs=4, segment_records=3, journal=JobJournal):
    j = journal(str(d), segment_records=segment_records)
    for i in range(n_jobs):
        j.append({"t": "accept", "job": {"job_id": f"j{i}", "synth": "stream:n_mem_ops=5"}})
        j.append({"t": "state", "job_id": f"j{i}", "state": "RUNNING"})
        j.append({"t": "state", "job_id": f"j{i}", "state": "DONE", "result": {"x": i}})
    j.close()
    return d


def _segments(d):
    return sorted(p for p in os.listdir(d) if p.startswith("journal-"))


def _flip(path, at):
    b = open(path, "rb").read()
    at = at if at >= 0 else len(b) // 2
    open(path, "wb").write(b[:at] + bytes([b[at] ^ 0xFF]) + b[at + 1:])


# ---- the trees -------------------------------------------------------------


def t_clean(root):
    _serve_journal(root / "sj")


def t_clean_jax_written(root):
    _serve_journal(root / "sj", journal=JJournal)


def t_torn_tail(root):
    _serve_journal(root / "sj")
    with open(root / "sj" / "journal.jsonl", "a") as f:
        f.write('{"c": 1, "r": {"t":"state","job_id"')


def t_rot(root):
    _serve_journal(root / "sj")
    _flip(root / "sj" / _segments(root / "sj")[0], 40)


def t_tamper(root):
    _serve_journal(root / "sj", n_jobs=5, segment_records=2)
    sp = root / "sj" / _segments(root / "sj")[1]
    header = json.loads(sp.read_text().splitlines()[0])["r"]
    sp.write_text(_frame(header) + "\n" + _frame({"t": "note", "msg": "tampered"}) + "\n")


def t_missing_segment(root):
    _serve_journal(root / "sj", n_jobs=5, segment_records=2)
    os.remove(root / "sj" / _segments(root / "sj")[1])


def t_transitions(root):
    j = JobJournal(str(root / "sj"), segment_records=None)
    j.append({"t": "accept", "job": {"job_id": "ja", "synth": "s"}})
    j.append({"t": "state", "job_id": "ja", "state": "DONE"})  # skips RUNNING
    j.append({"t": "state", "job_id": "ja", "state": "RUNNING"})  # post-terminal echo
    j.append({"t": "accept", "job": {"job_id": "jb", "synth": "s"}})
    j.append({"t": "state", "job_id": "jb", "state": "RUNNING"})
    j.append({"t": "state", "job_id": "jb", "state": "PENDING"})  # crash requeue
    j.append({"t": "state", "job_id": "jb", "state": "RUNNING"})
    j.append({"t": "state", "job_id": "ghost", "state": "RUNNING"})  # no accept
    j.append({"t": "state", "job_id": "jb", "state": "LIMBO"})
    j.close()


def _unit_spec():
    from primesim_tpu_torch.pool.units import unit_key

    spec = {"unit_id": "u1", "index": 0, "config": "{}", "synth": "s",
            "trace_path": None, "fold": True, "overrides": {},
            "chunk_steps": 16, "max_steps": 100}
    spec["key"] = unit_key(spec)
    return spec


def t_pool_keys(root):
    spec = _unit_spec()
    p = JobJournal(str(root / "ok"), segment_records=None)
    p.append({"t": "unit", "unit": dict(spec)})
    p.append({"t": "lease", "unit_id": "u1", "worker": "w", "epoch": 1, "key": spec["key"]})
    p.append({"t": "ack", "unit_id": "u1", "worker": "w", "epoch": 1, "key": spec["key"],
              "result": {}})
    p.close()
    p = JobJournal(str(root / "bad"), segment_records=None)
    p.append({"t": "unit", "unit": dict(spec)})
    p.append({"t": "lease", "unit_id": "u1", "worker": "w", "epoch": 1,
              "key": "deadbeefdeadbeef"})
    p.close()
    p = JobJournal(str(root / "edit"), segment_records=None)
    p.append({"t": "unit", "unit": dict(spec, max_steps=999_999)})
    p.close()


def _solo_npz(path, rows=None):
    from primesim_tpu_torch.sim.checkpoint import _FORMAT, atomic_save_npz
    from primesim_tpu_torch.stats.counters import COUNTER_NAMES

    atomic_save_npz(
        str(path), format=np.int64(_FORMAT), cycle_base=np.int64(0),
        steps_run=np.int64(0), config_json=np.frombuffer(b"{}", dtype=np.uint8),
        trace_sha=np.frombuffer(b"ab" * 32, dtype=np.uint8),
        state_counters=np.zeros((rows if rows is not None else len(COUNTER_NAMES), 4),
                                np.int32),
    )


def t_checkpoints(root):
    _solo_npz(root / "ok.npz")
    _solo_npz(root / "crc.npz")
    _flip(root / "crc.npz", -1)
    _solo_npz(root / "rows.npz", rows=3)
    (root / "empty.npz").write_bytes(b"")


def _warm(root, key, meta_over=None, sidecar=True):
    from primesim_tpu.sim.checkpoint import _FORMAT, atomic_save_npz  # the JAX writer
    from primesim_tpu.stats.counters import COUNTER_NAMES

    atomic_save_npz(
        str(root / f"{key}.npz"), format=np.int64(_FORMAT), warm=np.int64(1),
        steps=np.int64(512), cycle_base=np.int64(0), steps_run=np.int64(512),
        trace_sha=np.frombuffer(b"cd" * 32, dtype=np.uint8),
        state_counters=np.zeros((len(COUNTER_NAMES), 4), np.int32),
        host_counters=np.zeros((len(COUNTER_NAMES), 4), np.int64),
    )
    meta = {"cfg_key": "ef" * 32, "key": key, "trace_sha": "cd" * 32, "steps": 512}
    if sidecar:
        (root / f"{key}.json").write_text(json.dumps(dict(meta, **(meta_over or {}))))


def t_warm(root):
    _warm(root, "ab" * 32)
    _warm(root, "ac" * 32, {"steps": 1024})
    _warm(root, "ad" * 32, {"key": "ff" * 32, "trace_sha": "00" * 32})
    _warm(root, "ae" * 32, sidecar=False)
    (root / ("af" * 32 + ".json")).write_text(json.dumps({"key": "af" * 32}))  # orphan
    _warm(root, "b0" * 32, sidecar=False)
    (root / ("b0" * 32 + ".json")).write_text("{not json")


def _exec_entry(root, payload, body=b"executable", crc_flip=False, key=None,
                sidecar=True):
    key = key or TF._exec_key(payload)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    rec = b"PTEXEC01" + struct.pack("<I", crc ^ (1 if crc_flip else 0)) + body
    (root / f"{key}.bin").write_bytes(rec)
    if sidecar:
        (root / f"{key}.json").write_text(json.dumps({"key": key, "payload": payload}))
    return key


def t_exec(root):
    ex = root / "exec"
    ex.mkdir()
    jv, jlv = metadata.version("jax"), metadata.version("jaxlib")
    good = {"exec_format": 1, "ckpt_format": 7, "jax": jv, "jaxlib": jlv,
            "backend": "cpu", "devices": 8, "entry": "engine",
            "geom": "0" * 64, "statics": [16], "kwargs": {}, "tree": "T",
            "avals": [[[4], "int32", False]]}
    body = pickle.dumps({"blob": list(range(8))})
    _exec_entry(ex, good, body)
    _exec_entry(ex, dict(good, entry="rot"), body, crc_flip=True)
    _exec_entry(ex, dict(good, entry="drift", jax="0.0.1", jaxlib="0.0.1"), body)
    k = _exec_entry(ex, dict(good, entry="edited"), body)
    meta = json.loads((ex / f"{k}.json").read_text())
    meta["payload"]["entry"] = "tampered"
    (ex / f"{k}.json").write_text(json.dumps(meta))
    _exec_entry(ex, dict(good, entry="renamed"), body, key="1" * 64)
    (ex / f"{'1' * 64}.json").write_text(json.dumps({"key": "2" * 64, "payload": good}))
    missing = {k2: v for k2, v in good.items() if k2 != "backend"}
    _exec_entry(ex, dict(missing, entry="old"), body)
    _exec_entry(ex, dict(good, entry="lonely"), body, sidecar=False)
    (ex / ("3" * 64 + ".bin")).write_bytes(b"garbage")


def _at(head="a" * 64, chunks=3, start=0, chunk_steps=16):
    return {"head": head, "chunks": chunks, "start": start, "chunk_steps": chunk_steps}


def t_attest_records(root):
    j = JobJournal(str(root / "pool"), segment_records=None)
    for rec in [
        {"t": "ack", "unit_id": "u0", "attest": dict(_at(), head="zz")},
        {"t": "verdict", "unit_id": "u1", "outcome": "resolved", "attest": _at()},
        {"t": "ack", "unit_id": "u2", "attest": _at()},
        {"t": "suspect", "unit_id": "u2", "held": [{"worker": "w1", "attest": _at("b" * 64)}]},
        {"t": "audit", "unit_id": "u9", "worker": "w0", "ok": True},
        {"t": "ack", "unit_id": "u3", "attest": _at()},
        {"t": "suspect", "unit_id": "u3",
         "held": [{"worker": "w1", "attest": _at()}, {"worker": "w2", "attest": _at("b" * 64)}]},
        {"t": "verdict", "unit_id": "u3", "outcome": "resolved", "attest": _at()},
        {"t": "audit", "unit_id": "u3", "worker": "w3", "ok": True},
        {"t": "ack_dup", "unit_id": "u3", "attest": {"head": "c" * 64, "chunks": 0,
                                                      "start": 0, "chunk_steps": 16}},
    ]:
        j.append(rec)
    j.close()


def t_attest_checkpoint(root):
    """A pool ledger whose acked chain the surviving unit checkpoint
    contradicts (u00000), and one it prefixes (u00001): the port's fleet,
    coordinator and element checkpoint on the CPU."""
    from primesim_tpu_torch.attest import FleetAttest
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.pool import PoolCoordinator
    from primesim_tpu_torch.pool.units import build_units
    from primesim_tpu_torch.serve.scheduler import parse_synth_spec
    from primesim_tpu_torch.sim.checkpoint import save_element_checkpoint
    from primesim_tpu_torch.sim.fleet import FleetEngine

    cfg = MachineConfig.from_json(small_test_config(4).to_json())
    fleet = FleetEngine(cfg, [parse_synth_spec(SYNTH.format(7), 4, True)], [{}],
                        chunk_steps=16, device="cpu")
    fleet.attest = FleetAttest()
    fleet.attest.track(0, 16, start=0)
    for _ in range(2):
        fleet.step_chunk()
    ck = fleet.attest.payload(0)
    units = build_units(cfg, [], [SYNTH.format(i) for i in range(2)], [{}, {}], fold=True,
                        chunk_steps=16, max_steps=100_000)
    pool = str(root / "pool")
    coord = PoolCoordinator(units, pool, lease_ttl_s=5.0, attest="chain")
    for head in ("f" * 64, ck["head"]):
        g = coord.handle({"verb": "lease", "worker": "w1"})
        u = g["unit"]
        coord.handle({"verb": "ack", "worker": "w1", "unit_id": u["unit_id"],
                      "epoch": g["epoch"], "key": u["key"], "resumed_steps": 0,
                      "result": {"metric": "x", "value": 1}, "attest": dict(ck, head=head)})
        os.makedirs(os.path.join(pool, "units"), exist_ok=True)
        save_element_checkpoint(os.path.join(pool, "units", f"{u['unit_id']}.npz"), fleet, 0)
    coord.close(drained=False)


def t_quarantine(root):
    (root / "ck.npz").write_bytes(b"garbage, not a zip")
    (root / "leftover.npz.k3j2.tmp").write_bytes(b"partial")
    _serve_journal(root / "sj")
    _flip(root / "sj" / _segments(root / "sj")[0], 40)


TREES = {f.__name__[2:]: f for f in (
    t_clean, t_clean_jax_written, t_torn_tail, t_rot, t_tamper, t_missing_segment,
    t_transitions, t_pool_keys, t_checkpoints, t_warm, t_exec, t_attest_records,
    t_attest_checkpoint, t_quarantine)}
# what each tree must show, so a tree that went clean by mistake fails
EXPECT = {
    "clean": (0, 0), "clean_jax_written": (0, 0), "torn_tail": (0, 1), "rot": (2, 0),
    "tamper": (2, 0), "missing_segment": (3, 0), "transitions": (3, 0),
    "pool_keys": (2, 0), "checkpoints": (2, 1), "warm": (4, 2), "exec": (5, 2),
    "attest_records": (5, 0), "attest_checkpoint": (1, 0), "quarantine": (3, 1),
}


def _journal_dirs(root):
    return sorted({dp for dp, _, fs in os.walk(root)
                   if ".fsck-quarantine" not in dp
                   and any(f == "journal.jsonl" or f.startswith("journal-") for f in fs)})


@pytest.fixture(scope="module")
def clean_journal(tmp_path_factory):
    return str(_serve_journal(tmp_path_factory.mktemp("ref") / "sj"))


@pytest.mark.parametrize("tree", sorted(TREES))
def test_fsck_reports_equal_the_jax_package(tree, tmp_path, clean_journal):
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = tmp_path / pkg
        roots[pkg].mkdir()
        TREES[tree](roots[pkg])
    repair = "quarantine" if tree == "quarantine" else "none"
    reports = {}
    for pkg, F in (("jax", JF), ("port", TF)):
        root = str(roots[pkg])
        res = F.run_fsck(root, repair=repair)
        reports[pkg] = (F.render_json(res).replace(root, "ROOT"),
                        F.render_human(res).replace(root, "ROOT"),
                        # what a rescan of a quarantined tree still finds
                        F.render_json(F.run_fsck(root)).replace(root, "ROOT"), res)
    assert reports["port"][:3] == reports["jax"][:3]
    res = reports["port"][3]
    notes = len(res.findings) - len(res.corrupt)
    assert (len(res.corrupt), notes) == EXPECT[tree], res.findings
    for d in _journal_dirs(roots["port"]) or [str(roots["port"])]:
        j = d.replace(str(roots["port"]), str(roots["jax"]))
        a, b = TF.run_compare(d, clean_journal), JF.run_compare(j, clean_journal)
        assert a.clean == b.clean
        assert [f.as_dict() for f in a.findings] == [
            dict(f.as_dict(), path=f.path.replace(j, d)) for f in b.findings]
        assert a.checked == b.checked


def test_fsck_quarantine_moves_never_deletes(tmp_path):
    (tmp_path / "ck.npz").write_bytes(b"garbage, not a zip")
    (tmp_path / "leftover.npz.k3j2.tmp").write_bytes(b"partial")
    res = TF.run_fsck(str(tmp_path), repair="quarantine")
    assert sorted(res.quarantined) == ["ck.npz", "leftover.npz.k3j2.tmp"]
    q = tmp_path / ".fsck-quarantine"
    assert (q / "ck.npz").read_bytes() == b"garbage, not a zip"
    assert (q / "leftover.npz.k3j2.tmp").exists()
    assert not (tmp_path / "ck.npz").exists()
    assert TF.run_fsck(str(tmp_path)).clean
    with pytest.raises(FsckCorrupt):
        TF.run_fsck(str(tmp_path), repair="delete")
    with pytest.raises(FsckCorrupt):
        TF.run_fsck(str(tmp_path / "nope"))


def test_cli_fsck_exits_equal_primetpu(tmp_path, capsys):
    """Exit 2 with the JSON report on stdout and ONE structured error line
    on stderr on a rotted tree, exit 0 with the human summary on a clean
    one, and the same refusal with no DIR: the port's CLI and
    `primetpu`'s alike."""
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    bad, good = tmp_path / "bad", tmp_path / "good"
    t_rot(bad)
    t_clean(good)
    outs = []
    for fn in (jax_main, main):
        got = []
        for argv in (["fsck", str(bad), "--format", "json"], ["fsck", str(good)], ["fsck"]):
            rc = fn(argv)
            cap = capsys.readouterr()
            got.append((rc, cap.out, cap.err.strip().splitlines()[-1:]))
        outs.append(got)
    assert outs[0] == outs[1]
    (rc, out, err), (rc0, out0, _), (rc_none, _, err_none) = outs[1]
    assert rc == 2 and json.loads(out)["summary"]["corrupt"] >= 1
    e = json.loads(err[0])["error"]
    assert e["type"] == "FsckCorrupt" and e["location"]["n_corrupt"] >= 1
    assert rc0 == 0 and "0 corrupt" in out0
    assert rc_none == 2 and json.loads(err_none[0])["error"]["type"] == "FsckCorrupt"


def test_fsck_exec_drift_is_a_note_and_needs_no_jax_import(tmp_path, monkeypatch):
    """The toolchain the port compares an executable entry with is read
    from the distributions' metadata; where jax is not installed (the
    card's host) every JAX entry is a dead address: a note, never
    corruption."""
    t_exec(tmp_path)
    monkeypatch.setattr(TF, "_installed_version", lambda dist: None)
    res = TF.run_fsck(str(tmp_path))
    drift = [f for f in res.findings if "toolchain is None/None" in f.detail]
    assert len(drift) == 2 and not any(f.corrupt for f in drift)
    assert res.checked["exec_entries"] == 8
