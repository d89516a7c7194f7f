"""The port's crash campaigns (`primesim_tpu_torch/chaos/campaign.py`, the
`chaos` verb) and its site catalog against the JAX package's
`chaos/campaign.py` and `chaos/sites.py`, on the CPU, mirroring
tests/test_chaos.py.

The catalog comes first: both packages expand every seed to the same plan
for every class set the verb accepts, with the campaign's site lists and
with none. Then the port's fault-free reference run equals JAX's, the JAX
tests' hand-made serve-trial plans (a torn journal, a failed fsync, a torn
checkpoint, the ACK-window crashpoint, two scheduler crashpoints) give
equal trial results in both packages, and so does a 3-trial campaign. The
opt-in harnesses each run a clean trial in the port: the socket trial, the
replication trial (primary, two replicas, a standby that promotes), the
attestation trial with one counter flip, and the capacity trial with a
revocation (one device: nothing to take) and a sustained ENOSPC window. A
deliberate ACK-before-fsync bug shrinks to the plan JAX shrinks it to, a
JAX-written artifact replays to JAX's result through the verb, and the
verb exits 0 and 3. Integer simulator, byte formats: every comparison is
exact.
"""

from __future__ import annotations

import json

import pytest
import torch

from primesim_tpu.chaos import campaign as JC
from primesim_tpu.chaos import plan as JP
from primesim_tpu.chaos import sites as j_sites
from primesim_tpu.serve.journal import JobJournal as JJournal
from primesim_tpu_torch.chaos import campaign as TC
from primesim_tpu_torch.chaos import plan as TP
from primesim_tpu_torch.chaos import sites as t_sites
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.serve.journal import JobJournal

# the class sets `chaos --classes` accepts: each class alone and the
# default pair
CLASS_SETS = [("durable",), ("crashpoint",), ("socket",), ("replication",),
              ("silent_corruption",), ("capacity_loss",), ("durable", "crashpoint")]


@pytest.fixture(autouse=True)
def _no_leftover_runtime():
    """Chaos state is process-global in both packages; no test may leak
    an active plan."""
    j_sites.deactivate()
    t_sites.deactivate()
    yield
    j_sites.deactivate()
    t_sites.deactivate()


@pytest.fixture(scope="module")
def j_golden():
    j_sites.deactivate()
    return JC.golden_run()


@pytest.fixture(scope="module")
def t_golden():
    t_sites.deactivate()
    return TC.golden_run(device="cpu")


def _ev(P, site, occ, action, **args):
    return P.FaultEvent(site=site, occurrence=occ, action=action,
                        args=tuple(sorted(args.items())))


def _plan(P, seed, *events):
    return P.FaultPlan(seed=seed, events=tuple(_ev(P, *e[:3], **e[3]) for e in events))


# ---- the catalog ----------------------------------------------------------


@pytest.mark.parametrize("classes", CLASS_SETS, ids=",".join)
def test_generate_gives_the_jax_plan_for_every_seed(classes):
    """Seeds 0-199 expand to the same plan in both packages, over the
    campaign's site list for the class set and over the whole catalog."""
    names, _ = JC._trial_sites(classes)
    gen = JC._gen_classes(classes)
    for seed in range(200):
        for sites in (names, None):
            j = JP.generate(seed, classes=gen, sites=sites)
            t = TP.generate(seed, classes=gen, sites=sites)
            assert t.as_dict() == j.as_dict(), (seed, sites)


def test_the_catalog_and_the_trial_site_lists_are_the_jax_package_s():
    assert t_sites.SITES == j_sites.SITES
    for classes in CLASS_SETS:
        assert TC._trial_sites(classes) == JC._trial_sites(classes)
        assert TC._gen_classes(classes) == JC._gen_classes(classes)
    assert (TC.SERVE_SITES, TC.REPLICATION_SITES, TC.ATTEST_SITES, TC.CAPACITY_SITES,
            TC.DEFAULT_SPECS) == (JC.SERVE_SITES, JC.REPLICATION_SITES, JC.ATTEST_SITES,
                                  JC.CAPACITY_SITES, JC.DEFAULT_SPECS)


def test_device_revoke_fires_once_and_counts_arrivals():
    plan = _plan(TP, 0, ("devices.revoke", 2, "revoke", {"n": 1}))
    rt = t_sites.install(plan, mode="raise")
    assert t_sites.device_revoke("devices.revoke") is None
    ev = t_sites.device_revoke("devices.revoke")
    assert ev is not None and ev.arg("n") == 1
    assert t_sites.device_revoke("devices.revoke") is None
    assert rt.counts["devices.revoke"] == 3
    assert rt.injected == [{"site": "devices.revoke", "occurrence": 2, "action": "revoke"}]


# ---- the serve trial -------------------------------------------------------


def test_golden_run_equals_the_jax_package_s(j_golden, t_golden):
    assert sorted(t_golden) == sorted(j_golden) == [0, 1, 2]
    for i in j_golden:
        assert t_golden[i]["state"] == "DONE"
        assert TC._canon(t_golden[i]) == JC._canon(j_golden[i])


SERVE_PLANS = {
    "torn_journal": (1, ("journal.append", 2, "torn", {"frac": 0.4})),
    "fsync_failure": (2, ("journal.append", 1, "fsync_fail", {})),
    "torn_checkpoint": (3, ("checkpoint.write", 2, "torn", {"frac": 0.3})),
    "ack_window": (4, ("server.post-journal-pre-ack", 1, "kill", {})),
    "scheduler_crashpoints": (5, ("scheduler.pre-dispatch", 2, "kill", {}),
                              ("scheduler.post-checkpoint", 3, "kill", {})),
}


@pytest.mark.parametrize("name", SERVE_PLANS)
def test_serve_trial_equals_the_jax_package_s(name, j_golden, t_golden):
    seed, *events = SERVE_PLANS[name]
    j = JC.run_serve_trial(_plan(JP, seed, *events), golden=j_golden)
    t = TC.run_serve_trial(_plan(TP, seed, *events), golden=t_golden, device="cpu")
    assert t.ok, t.violations
    assert t.injected
    assert t.as_dict() == j.as_dict()


def test_three_trial_campaign_equals_the_jax_package_s():
    j_trials, t_trials = [], []
    j = JC.run_campaign(n_trials=3, seed0=900,
                        progress=lambda s, r: j_trials.append(r.as_dict()))
    t = TC.run_campaign(n_trials=3, seed0=900, device="cpu",
                        progress=lambda s, r: t_trials.append(r.as_dict()))
    assert t == j and t["ok"] and t["fired_events"] > 0
    assert t_trials == j_trials


# ---- the opt-in harnesses ----------------------------------------------------


def test_socket_trial(t_golden):
    """Lost reply on the wire: the client's token-carrying retry must not
    twin the job."""
    plan = _plan(TP, 6, ("protocol.recv", 1, "disconnect", {}),
                 ("protocol.send", 3, "short_send", {"frac": 0.5}))
    res = TC.run_socket_trial(plan, golden=t_golden, device="cpu")
    assert res.ok, res.violations
    assert len(res.injected) == 2


def test_replication_trial(t_golden, tmp_path):
    """A replica killed before its fsync-ack and a partitioned order: the
    standby promotes off the replicas and finishes every job as golden,
    and the deposed primary cannot reach its quorum."""
    plan = _plan(TP, 1, ("replica.pre-fsync-ack", 1, "kill", {}),
                 ("replicate.send", 3, "partition", {"s": 0.05}))
    res = TC.run_trial(plan, golden=t_golden, workdir=str(tmp_path), device="cpu")
    assert res.ok, res.violations
    assert res.injected


def test_attestation_trial_with_one_counter_flip():
    """Invariant F: a flipped committed counter never ends DONE unflagged.
    (The trial's own temporary directories: the pool's unix socket path
    must stay short.)"""
    plan = _plan(TP, 11, ("fleet.counters", 1, "flip", {}))
    res = TC.run_trial(plan, device="cpu")
    assert res.ok, res.violations
    assert any(e["site"] == "fleet.counters" for e in res.injected)


def test_capacity_trial_with_a_revocation_and_an_enospc_window(t_golden, tmp_path):
    """Invariant G: the supervised run under a revocation (on the mesh of
    the 8 visible devices: it reshards) equals the fault-free reference,
    and every ACKed job survives a sustained ENOSPC window."""
    plan = _plan(TP, 8, ("devices.revoke", 1, "revoke", {"n": 1}),
                 ("disk.preflight", 2, "enospc_window", {"calls": 3}))
    res = TC.run_trial(plan, golden=t_golden, workdir=str(tmp_path), device="cpu")
    assert res.ok, res.violations
    assert {e["site"] for e in res.injected} == {"devices.revoke", "disk.preflight"}


def test_capacity_supervisor_half_reshards_on_the_mesh_to_the_jax_reference(tmp_path):
    """The capacity trial's sharded half: on the 8 visible devices the
    engine holds a mesh of 8 (the capacity workload's 8 cores and banks),
    a revocation of two shards at the second boundary reshards it 8 -> 4,
    and the recovered run equals the JAX package's unsharded fault-free
    reference (JAX shards its half over GSPMD; its reference does not
    depend on the mesh). With one visible device the half runs unsharded
    and the revocation takes nothing."""
    import numpy as np

    from primesim_tpu_torch.parallel import sharding

    jref = JC._capacity_reference()
    tref = TC._capacity_reference(torch.device("cpu"))
    np.testing.assert_array_equal(tref["cycles"], np.asarray(jref["cycles"]))
    for k, v in jref["counters"].items():
        np.testing.assert_array_equal(tref["counters"][k], np.asarray(v), err_msg=k)
    plan = _plan(TP, 8, ("devices.revoke", 2, "revoke", {"n": 2}))
    for visible, rungs in ((None, ["reshard:8->4"]), (1, [])):
        sharding.virtual_devices(visible, "cpu" if visible else None)
        violations: list = []
        t_sites.install(plan, mode="raise")
        try:
            out = TC._capacity_supervisor_half(str(tmp_path / f"v{visible}"), violations, jref,
                                               torch.device("cpu"))
        finally:
            t_sites.deactivate()
            sharding.virtual_devices(None)
        assert violations == [] and out == {"degrade_rungs": rungs}
        assert sharding.healthy_devices("cpu") == sharding.visible_devices("cpu")


def test_campaign_without_a_card_or_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.run_campaign(n_trials=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["chaos", "--trials", "1"])


# ---- the shrinker, the artifacts and the verb ---------------------------------


def test_shrinker_catches_a_deliberate_ack_before_fsync_bug(tmp_path, monkeypatch,
                                                            j_golden, t_golden):
    """Break the ACK invariant on purpose (accept returns without
    journaling) in both packages: the crash after the ACKs surfaces it as
    an invariant-A violation, and both shrink it to the same one-event
    plan, whose artifact replays the violation."""
    monkeypatch.setattr(JJournal, "accept", lambda self, job: None)
    monkeypatch.setattr(JobJournal, "accept", lambda self, job: None)
    events = (("scheduler.pre-dispatch", 1, "kill", {}),
              ("checkpoint.write", 9, "delay", {"s": 0.001}))  # an innocent rider
    shrunk = {}
    for name, C, P, golden, kw in (("jax", JC, JP, j_golden, {}),
                                   ("port", TC, TP, t_golden, {"device": "cpu"})):
        res = C.run_serve_trial(_plan(P, 77, *events), golden=golden, **kw)
        assert any("invariant A" in v for v in res.violations), (name, res.violations)

        def lost_ack(p, C=C, golden=golden, kw=kw):
            r = C.run_serve_trial(p, golden=golden, **kw)
            return any("invariant A" in v for v in r.violations)

        shrunk[name] = P.shrink(_plan(P, 77, *events), lost_ack)
    assert shrunk["port"].as_dict() == shrunk["jax"].as_dict()
    assert [e.site for e in shrunk["port"].events] == ["scheduler.pre-dispatch"]
    art = tmp_path / "repro.json"
    art.write_text(json.dumps({"seed": 77, "plan": shrunk["port"].as_dict()}))
    assert not TC.replay_artifact(str(art), device="cpu").ok
    assert main(["chaos", "--plan", str(art), "--device", "cpu"]) == 3


def test_chaos_plan_replays_a_jax_artifact(tmp_path, capsys):
    """A JAX-written repro artifact (a torn journal write) replays through
    the port's verb to JAX's trial result, and the port's stderr line
    names its device."""
    plan = _plan(JP, 1, ("journal.append", 2, "torn", {"frac": 0.4}))
    art = tmp_path / "repro.json"
    art.write_text(json.dumps({"seed": 1, "plan": plan.as_dict(), "original_events": 1,
                               "shrunk_events": 1, "violations": [], "injected": [],
                               "repro": "primetpu chaos --plan <this file>"}))
    want = JC.replay_artifact(str(art)).as_dict()
    capsys.readouterr()
    assert main(["chaos", "--plan", str(art), "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out) == want
    assert err.splitlines()[-1].startswith("chaos: device cpu, ")


def test_chaos_verb_exits_0_on_a_clean_campaign(tmp_path, capsys):
    rc = main(["chaos", "--trials", "2", "--seed", "321", "--classes", "durable",
               "--out", str(tmp_path / "art"), "--verbose", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0, out
    report = json.loads(out)
    assert report["ok"] and report["trials"] == 2 and report["classes"] == ["durable"]
    assert [ln.split()[1] for ln in err.splitlines() if ln.startswith("trial ")] == [
        "seed=321", "seed=322"]
