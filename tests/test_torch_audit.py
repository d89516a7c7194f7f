"""The port's offline replay audit (`primesim_tpu_torch/attest/audit.py`,
the `audit` verb) against the JAX package's `attest/audit.py`, on the CPU,
mirroring the offline-audit cases of tests/test_attest.py.

One attested pool campaign of two units is drained by the port's
coordinator and worker at module scope; every test reads (never writes)
its directory or a copy. Both packages' `run_audit` replay its units and
give equal verdicts, each `ok` with the ack confirmed. A unit checkpoint
that prefixes the replayed chain is confirmed at its chunk by both, a
forged one is a mismatch in both; a ledger whose acked head was forged is
a mismatch in both, and a torn ledger tail is survived by both and left
byte-identical. `--unit` selection and an unknown unit, and the verb's
exit contract (one JSON verdict per unit, exit 2 with one structured line
for a missing directory or a mismatch), equal `primetpu`'s. A unit served
from a slot bucket, a hedged twin's retained losing ack and a terminal
SUSPECT's held payloads are judged alike by both. A unit sharded over
several devices is skipped with the pool worker's reason, and the verb
asked for the card with none present raises.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

from primesim_tpu.attest import audit as JA
from primesim_tpu.attest.errors import AttestationError as JAttestationError
from primesim_tpu.config.machine import small_test_config
from primesim_tpu_torch.analysis.fsck import _check_journal_dir
from primesim_tpu_torch.attest import audit as TA
from primesim_tpu_torch.attest.errors import AttestationError
from primesim_tpu_torch.serve.journal import JobJournal

from test_torch_engine import port_cfg

SYNTH = "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed={}"


@pytest.fixture(scope="module")
def drained_pool(tmp_path_factory):
    """One attested pooled campaign of two units, drained by the port's
    coordinator and one in-process worker on the CPU."""
    from primesim_tpu_torch.pool import PoolCoordinator, PoolWorker
    from primesim_tpu_torch.pool.units import build_units

    root = str(tmp_path_factory.mktemp("audpool") / "pool")
    units = build_units(port_cfg(small_test_config(4)), [],
                        [SYNTH.format(101), SYNTH.format(102)], [{}, {}], fold=True,
                        chunk_steps=16, max_steps=100_000)
    coord = PoolCoordinator(units, root, lease_ttl_s=30.0, attest="chain")
    coord.start()
    try:
        assert PoolWorker(coord.socket_path, "w0", reconnect_timeout_s=10.0,
                          device="cpu").run() == 0
        assert all(r["state"] == "DONE" for r in coord.results())
    finally:
        coord.close()
    return root


def _both(root, **kw):
    """(the port's audit, the JAX package's) of one directory."""
    return (TA.run_audit(root, device="cpu", **kw), JA.run_audit(root, **kw))


def _copy(drained_pool, tmp_path, name):
    root = str(tmp_path / name)
    shutil.copytree(drained_pool, root)
    return root


def _rewrite(drained_pool, tmp_path, name, edit):
    """A copy of the pool whose ledger is rewritten record by record
    through `edit(rec) -> [records]` (validly framed: fsck stays green)."""
    root = _copy(drained_pool, tmp_path, name)
    records, _ = _check_journal_dir(root, root)
    for seg in os.listdir(root):
        if seg.startswith("journal"):
            os.unlink(os.path.join(root, seg))
    jj = JobJournal(root)
    for rec in records:
        for r in edit(rec):
            jj.append(r)
    jj.close()
    return root


def test_audit_confirms_the_port_campaign_equal_to_jax(drained_pool):
    t, j = _both(drained_pool)
    assert t["units"] == j["units"] and t["summary"] == j["summary"]
    assert t["summary"]["audited"] == 2 and t["summary"]["ok"] == 2
    for v in t["units"]:
        assert v["detail"]["ack"] == "confirmed" and v["detail"]["replay"]["head"]
    assert sorted(t["replay_wall_s"]) == ["u00000", "u00001"]


def test_audit_holds_unit_checkpoints_to_the_replay(drained_pool, tmp_path):
    """A unit checkpoint of the first chunk (the port's fleet on the CPU)
    is a prefix of the replayed chain: confirmed at chunk 1 by both
    packages; the same file under the other unit's name diverges there:
    a mismatch in both."""
    from primesim_tpu_torch.attest import FleetAttest
    from primesim_tpu_torch.serve.scheduler import parse_synth_spec
    from primesim_tpu_torch.sim.checkpoint import save_element_checkpoint
    from primesim_tpu_torch.sim.fleet import FleetEngine

    root = _copy(drained_pool, tmp_path, "ckpt")
    cfg = port_cfg(small_test_config(4))
    fleet = FleetEngine(cfg, [parse_synth_spec(SYNTH.format(101), 4, True)], [{}],
                        chunk_steps=16, device="cpu")
    fleet.attest = FleetAttest()
    fleet.attest.track(0, 16, start=0)
    fleet.step_chunk()
    os.makedirs(os.path.join(root, "units"), exist_ok=True)
    for uid in ("u00000", "u00001"):
        save_element_checkpoint(os.path.join(root, "units", f"{uid}.npz"), fleet, 0)
    t, j = _both(root)
    assert t["units"] == j["units"] and t["summary"] == j["summary"]
    by = {v["unit_id"]: v for v in t["units"]}
    assert by["u00000"]["status"] == "ok"
    assert by["u00000"]["detail"]["checkpoint"] == "prefix ok at chunk 1"
    assert by["u00001"]["status"] == "mismatch"
    assert "diverges from the replay" in by["u00001"]["detail"]["checkpoint"]


def _forge(uid):
    """A ledger edit: `uid`'s acked chain head replaced by a forged one."""
    def edit(rec):
        if rec.get("t") == "ack" and rec["unit_id"] == uid:
            return [dict(rec, attest=dict(rec["attest"], head="e" * 64))]
        return [rec]
    return edit


def test_audit_flags_a_forged_ledger_head_in_both(drained_pool, tmp_path):
    forged = "u00000"
    root = _rewrite(drained_pool, tmp_path, "forged", _forge(forged))
    t, j = _both(root)
    assert t["units"] == j["units"] and t["summary"] == j["summary"]
    assert t["summary"]["mismatch"] == 1
    bad = {v["unit_id"]: v for v in t["units"]}[forged]
    assert bad["status"] == "mismatch"
    assert bad["detail"]["ack"]["journaled_head"] == "e" * 64


def test_audit_survives_a_torn_ledger_tail_in_both(drained_pool, tmp_path):
    root = _copy(drained_pool, tmp_path, "torn")
    active = os.path.join(root, "journal.jsonl")
    with open(active, "ab") as f:
        f.write(b'{"t":"ack","unit_id":"u9')
    before = open(active, "rb").read()
    t, j = _both(root)
    assert t["units"] == j["units"] and t["summary"]["ok"] == j["summary"]["ok"] == 2
    assert open(active, "rb").read() == before


def test_audit_unit_selection_and_unknown_units_equal_jax(drained_pool):
    t, j = _both(drained_pool, unit_ids=["u00001"])
    assert [v["unit_id"] for v in t["units"]] == ["u00001"]
    assert t["units"] == j["units"]
    errs = []
    for fn, exc in ((lambda: TA.run_audit(drained_pool, unit_ids=["nope"], device="cpu"),
                     AttestationError),
                    (lambda: JA.run_audit(drained_pool, unit_ids=["nope"]), JAttestationError)):
        with pytest.raises(exc) as ei:
            fn()
        errs.append((str(ei.value), ei.value.location()))
    assert errs[0] == errs[1] and errs[0][1]["site"] == "audit.ledger"


def test_audit_adjudicates_evidence_and_bucketed_units_equal_jax(drained_pool, tmp_path):
    """The evidence paths, in both packages alike: u00000 served from a
    2-page slot bucket (`capacity_pages`: replayed through `make_slots`
    and `replace_element`) with a hedged twin's losing ack retained, and
    u00001 a terminal SUSPECT whose held payloads are the true head and a
    divergent one: adjudicated for the worker that agrees."""
    from primesim_tpu_torch.pool.units import unit_key

    def edit(rec):
        if rec.get("t") == "unit" and rec["unit"]["unit_id"] == "u00000":
            spec = dict(rec["unit"], capacity_pages=2)
            return [dict(rec, unit=dict(spec, key=unit_key(spec)))]
        if rec.get("t") == "ack" and rec["unit_id"] == "u00000":
            return [rec, {"t": "ack_dup", "unit_id": "u00000", "worker": "w7", "epoch": 2,
                          "result": rec.get("result"),
                          "attest": dict(rec["attest"], head="d" * 64)}]
        if rec.get("t") == "ack" and rec["unit_id"] == "u00001":
            held = [{"worker": "w1", "attest": rec["attest"]},
                    {"worker": "w2", "attest": dict(rec["attest"], head="b" * 64)}]
            return [rec, {"t": "suspect", "unit_id": "u00001", "workers": ["w1", "w2"],
                          "held": held},
                    {"t": "verdict", "unit_id": "u00001", "outcome": "unresolved",
                     "held": held}]
        return [rec]

    root = _rewrite(drained_pool, tmp_path, "evidence", edit)
    t, j = _both(root)
    assert t["units"] == j["units"] and t["summary"] == j["summary"]
    by = {v["unit_id"]: v for v in t["units"]}
    assert by["u00000"]["status"] == "ok"
    assert by["u00000"]["detail"]["evidence"] == [
        {"kind": "hedge_dup", "worker": "w7", "agrees": False}]
    assert by["u00001"]["status"] == "adjudicated"
    assert by["u00001"]["detail"]["suspect"] == {"agrees_with_replay": ["w1"],
                                                 "disagrees": ["w2"]}


def test_audit_skips_a_sharded_unit_with_the_workers_reason(drained_pool, tmp_path):
    from primesim_tpu_torch.pool.units import unit_key
    from primesim_tpu_torch.pool.worker import MultiDeviceNotPorted

    def edit(rec):
        if rec.get("t") == "unit" and rec["unit"]["unit_id"] == "u00000":
            spec = dict(rec["unit"], devices=2)
            return [dict(rec, unit=dict(spec, key=unit_key(spec)))]
        return [rec]

    out = TA.run_audit(_rewrite(drained_pool, tmp_path, "sharded", edit), device="cpu")
    by = {v["unit_id"]: v for v in out["units"]}
    assert by["u00000"]["status"] == "skipped"
    assert by["u00000"]["detail"]["reason"] == str(MultiDeviceNotPorted(2))
    assert by["u00001"]["status"] == "ok" and out["summary"]["skipped"] == 1


def test_cli_audit_exit_contract_equals_primetpu(drained_pool, tmp_path, capsys,
                                                 monkeypatch):
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    forged = _rewrite(drained_pool, tmp_path, "forged", _forge("u00001"))
    outs = []
    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        got = []
        for d in (drained_pool, drained_pool + "-nope", forged):
            rc = fn(["audit", d, *extra])
            cap = capsys.readouterr()
            err = cap.err.strip().splitlines()
            got.append((rc, [json.loads(ln) for ln in cap.out.splitlines() if ln.strip()],
                        err[0], err[-1] if rc == 2 else None))
            if fn is main and rc != 2 or fn is main and d == forged:
                port_line = [ln for ln in err if ln.startswith("audit: device cpu, ")]
                assert len(port_line) == 1
                extra_rec = json.loads(port_line[0].partition(", ")[2])
                assert sorted(extra_rec["replay_wall_s"]) == ["u00000", "u00001"]
        outs.append(got)
    assert outs[0] == outs[1]
    (rc, lines, summary, _), (rc_missing, _, _, err_missing), (rc_bad, _, _, err_bad) = outs[1]
    assert rc == 0 and [v["status"] for v in lines] == ["ok", "ok"]
    assert summary.startswith("audit: 2 unit(s) replayed — 2 ok, 0 mismatch")
    e = json.loads(err_missing)["error"]
    assert rc_missing == 2 and e["type"] == "AttestationError"
    assert e["location"]["site"] == "audit.ledger"
    e = json.loads(err_bad)["error"]
    assert rc_bad == 2 and e["location"] == {"site": "audit.replay", "unit": "u00001"}

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["audit", drained_pool])
