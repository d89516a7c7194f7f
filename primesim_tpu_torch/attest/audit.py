"""Offline replay audit — `audit DIR` (DESIGN.md §24), the JAX
package's `attest/audit.py` for the port: the replays run as B = 1
fleets on the device the caller resolves (the card unless it asks for
the CPU), and their chain heads are the JAX package's, so the port
audits a pool directory either package wrote, verdict for verdict. A
unit sharded over several devices (`devices` > 0) is skipped with the
reason the port's pool worker quarantines it for.

A pool directory is self-describing: the ledger journals every unit's
full SPEC (config JSON, workload, overrides, chunk cadence) next to the
acked result and its fingerprint-chain head, and retains the losing
half of every hedged pair as `ack_dup` evidence. This module
re-executes DONE units from those specs — in this process, long after
the campaign and its workers are gone — and compares the recomputed
chain head against everything the ledger recorded:

  - the authoritative ack's chain head (a mismatch means the campaign
    shipped a result no honest execution reproduces — the finding
    the `audit` verb exists for);
  - every retained `ack_dup` / held payload, so a unit parked in the
    terminal SUSPECT state gets adjudicated offline: the replay is the
    third execution the live tiebreak never got;
  - the unit's surviving element checkpoint, whose chain members must
    be a PREFIX of the replayed chain (the ack-vs-checkpoint agreement
    fsck checks statically, proven dynamically here).

The ledger is read with fsck's read-only segment reader — never via
JobJournal, whose constructor repairs crash debris — so auditing a
kill -9'd campaign leaves its evidence byte-identical.

Only chains with `start == 0` and an unhalved cadence are replayable
from scratch; a warm-forked or OOM-halved execution's chain is
reported as `incomparable`, never as a mismatch (chain.comparable's
rule, applied offline).
"""

from __future__ import annotations

import os
import time

from .chain import comparable, heads_equal
from .errors import AttestationError


def _ledger_records(root: str) -> list:
    from ..analysis.fsck import _check_journal_dir

    records, findings = _check_journal_dir(root, root)
    corrupt = [f for f in findings if f.corrupt]
    if corrupt:
        raise AttestationError(
            f"{root}: pool ledger fails verification before any replay "
            f"({corrupt[0].path}: {corrupt[0].detail}); run the "
            "`fsck` verb first",
            site="audit.ledger",
        )
    if not records:
        raise AttestationError(
            f"{root}: no pool ledger found (need a `sweep --workers` / "
            "dispatch pool directory)",
            site="audit.ledger",
        )
    return records


def audit_targets(root: str) -> list:
    """Fold the ledger into audit targets: one entry per unit carrying
    its spec, the authoritative attest payload, and every piece of
    retained divergence evidence."""
    from ..pool.units import fold_unit_records

    records = _ledger_records(root)
    specs: dict = {}
    for rec in records:
        if rec.get("t") == "unit":
            spec = rec.get("unit") or {}
            uid = str(spec.get("unit_id", ""))
            if uid:
                specs.setdefault(uid, spec)
    units, _ = fold_unit_records(records)
    out = []
    for uid in sorted(set(specs) | set(units)):
        u = units.get(uid, {})
        out.append({
            "unit_id": uid,
            "spec": specs.get(uid),
            "attest": u.get("attest"),
            "result": u.get("result"),
            "poison": bool(u.get("poison")),
            "suspect": u.get("suspect"),
            "held": list(u.get("held") or []),
            "dup_acks": list(u.get("dup_acks") or []),
            "ack_worker": u.get("ack_worker"),
        })
    return out


def replay_unit(spec: dict, device=None) -> dict:
    """Re-execute one unit from its journaled spec with a fresh chain,
    on `device` (None: the card). Returns {attest, heads, result} where
    `heads` is the chain head after every committed chunk (the
    checkpoint cross-check index) and `result` carries the replayed
    counters summary."""
    from ..config.machine import MachineConfig
    from ..serve.scheduler import PAGE_EVENTS, parse_synth_spec
    from ..sim.fleet import FleetEngine
    from ..sim.supervisor import RunSupervisor
    from ..trace.format import Trace, fold_ins
    from .chain import FleetAttest

    cfg = MachineConfig.from_json(spec["config"])
    if spec.get("synth") is not None:
        trace = parse_synth_spec(spec["synth"], cfg.n_cores,
                                 bool(spec.get("fold")))
    else:
        trace = Trace.load(spec["trace_path"])
        if spec.get("fold"):
            trace = fold_ins(trace)
    if int(spec.get("devices") or 0):
        from ..pool.worker import MultiDeviceNotPorted

        raise MultiDeviceNotPorted(int(spec["devices"]))
    cs = int(spec["chunk_steps"])
    if spec.get("capacity_pages") is not None:
        fleet = FleetEngine.make_slots(
            cfg, 1, int(spec["capacity_pages"]) * PAGE_EVENTS,
            chunk_steps=cs, device=device,
        )
        fleet.replace_element(0, trace,
                              override=dict(spec.get("overrides") or {}))
    else:
        fleet = FleetEngine(
            cfg, [trace], [dict(spec.get("overrides") or {})],
            chunk_steps=cs, device=device,
        )
    fa = FleetAttest()
    fa.track(0, cs, start=0)
    fleet.attest = fa
    heads: list = []

    def on_chunk(sup):
        ch = fa.chain(0)
        if ch is not None and ch.chunks > len(heads):
            heads.append(ch.head)

    sup = RunSupervisor(fleet, handle_signals=False, on_chunk=on_chunk)
    sup.run(max_steps=int(spec["max_steps"]))
    ec = fleet.element_counters(0)
    return {
        "attest": fa.payload(0),
        "heads": heads,
        "result": {
            "instructions": int(ec["instructions"].sum()),
            "max_core_cycles": int(fleet.cycles[0].max()),
            "steps": int(fleet.steps_run[0]),
        },
    }


def _checkpoint_attest(root: str, unit_id: str):
    """The unit's surviving element checkpoint chain members, or None.
    Unreadable / digest-refuted checkpoints surface as a verdict, not a
    crash — the audit's whole point is distrusting artifacts."""
    from ..sim.checkpoint import _attest_from, load_verified_npz

    path = os.path.join(root, "units", f"{unit_id}.npz")
    if not os.path.exists(path):
        return None, None
    try:
        z = load_verified_npz(path)
        return _attest_from(z), None
    except Exception as e:  # noqa: BLE001 — any rot is a finding here
        return None, f"{type(e).__name__}: {e}"


def audit_unit(root: str, target: dict, device=None) -> dict:
    """Replay one target on `device` and judge every recorded chain
    against the replay. Returns a verdict record (one JSON line on the
    CLI)."""
    uid = target["unit_id"]
    spec = target.get("spec")
    verdict = {"unit_id": uid, "status": "ok", "detail": {}}

    def skip(why: str) -> dict:
        verdict["status"] = "skipped"
        verdict["detail"]["reason"] = why
        return verdict

    if spec is None:
        return skip("no spec record in the ledger (pre-§24 campaign?)")
    if spec.get("kind") == "ingest":
        return skip("ingest units carry no chain (segment files have "
                    "their own framing)")
    if target["poison"]:
        return skip("poisoned unit — there is no result to audit")
    at = target.get("attest")
    if target.get("suspect") != "terminal" and not (at and at.get("head")):
        return skip("no chain on record (attest was off, or the unit "
                    "never finished)")
    if at and int(at.get("start", 0)) != 0:
        return skip("chain starts mid-run (warm fork / resumed cadence "
                    "change); only start-0 chains replay from scratch")

    if int(spec.get("devices") or 0):
        from ..pool.worker import MultiDeviceNotPorted

        return skip(str(MultiDeviceNotPorted(int(spec["devices"]))))

    replay = replay_unit(spec, device=device)
    rp = replay["attest"]
    verdict["detail"]["replay"] = {"head": rp["head"],
                                   "chunks": rp["chunks"],
                                   **replay["result"]}

    # 1) the authoritative ack (absent for terminal-SUSPECT units)
    if at and at.get("head"):
        if not comparable(at, rp):
            verdict["status"] = "incomparable"
            verdict["detail"]["reason"] = (
                "journaled chain cadence/coverage differs from the "
                "replay (OOM-halved chunk cadence?)"
            )
        elif heads_equal(at, rp):
            verdict["detail"]["ack"] = "confirmed"
        else:
            verdict["status"] = "mismatch"
            verdict["detail"]["ack"] = {
                "worker": target.get("ack_worker"),
                "journaled_head": at["head"],
            }

    # 2) retained divergence evidence: held payloads + hedged-twin
    #    losers — the replay adjudicates what the live tiebreak couldn't
    evidence = []
    for h in target["held"]:
        evidence.append(("held", h))
    for d in target["dup_acks"]:
        evidence.append(("audit_dup" if d.get("audit") else "hedge_dup",
                         d))
    judged = []
    for kind, e in evidence:
        ea = e.get("attest")
        if not (ea and ea.get("head")):
            continue
        judged.append({
            "kind": kind,
            "worker": str(e.get("worker", "?")),
            # None = incomparable cadence, never counted either way
            "agrees": (heads_equal(ea, rp)
                       if comparable(ea, rp) else None),
        })
    if judged:
        verdict["detail"]["evidence"] = judged
    if target.get("suspect") == "terminal":
        agreeing = sorted({j["worker"] for j in judged if j["agrees"]})
        verdict["status"] = "adjudicated" if agreeing else "mismatch"
        verdict["detail"]["suspect"] = {
            "agrees_with_replay": agreeing,
            "disagrees": sorted(
                {j["worker"] for j in judged if j["agrees"] is False}
            ),
        }

    # 3) checkpoint prefix agreement (the dynamic half of fsck's static
    #    ack-vs-checkpoint check)
    ca, rot = _checkpoint_attest(root, uid)
    if rot is not None:
        verdict["status"] = "mismatch"
        verdict["detail"]["checkpoint"] = f"unreadable: {rot}"
    elif ca and ca.get("head") and int(ca.get("start", 0)) == 0 \
            and int(ca.get("chunk_steps", 0)) == int(rp["chunk_steps"]):
        k = int(ca.get("chunks", 0))
        if 1 <= k <= len(replay["heads"]):
            if replay["heads"][k - 1] == ca["head"]:
                verdict["detail"]["checkpoint"] = f"prefix ok at chunk {k}"
            else:
                verdict["status"] = "mismatch"
                verdict["detail"]["checkpoint"] = (
                    f"chain head at chunk {k} diverges from the replay "
                    "— the checkpoint holds state no honest execution "
                    "committed"
                )
    return verdict


def run_audit(root: str, unit_ids=None, device=None) -> dict:
    """Audit every replayable unit under `root` (or just `unit_ids`),
    replaying on `device` (None: the card, an error when there is none).
    Returns {root, units: [verdict...], summary: {...}} as the JAX
    package does, plus `replay_wall_s` {unit id: seconds} of the units
    it replayed; the CLI raises AttestationError when any verdict is a
    mismatch."""
    from ..sim.engine import resolve_device

    root = os.path.abspath(root)
    if not os.path.isdir(root):
        raise AttestationError(f"not a directory: {root}",
                               site="audit.ledger")
    targets = audit_targets(root)
    if unit_ids:
        want = {str(u) for u in unit_ids}
        unknown = want - {t["unit_id"] for t in targets}
        if unknown:
            raise AttestationError(
                f"unknown unit id(s): {', '.join(sorted(unknown))}",
                site="audit.ledger", unit=sorted(unknown)[0],
            )
        targets = [t for t in targets if t["unit_id"] in want]
    device = resolve_device(device)
    verdicts, walls = [], {}
    for t in targets:
        t0 = time.perf_counter()
        verdicts.append(audit_unit(root, t, device=device))
        if "replay" in verdicts[-1]["detail"]:
            walls[t["unit_id"]] = time.perf_counter() - t0
    summary = {"audited": 0, "ok": 0, "mismatch": 0, "adjudicated": 0,
               "incomparable": 0, "skipped": 0}
    for v in verdicts:
        s = v["status"]
        if s != "skipped":
            summary["audited"] += 1
        summary[s] = summary.get(s, 0) + 1
    return {"root": root, "units": verdicts, "summary": summary,
            "replay_wall_s": walls}
