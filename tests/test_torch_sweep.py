"""`python -m primesim_tpu_torch sweep` (on the CPU) against `primetpu
sweep` on the same arguments: the same lines key for key but for the
host's wall time and the MIPS derived from it, the same stderr warnings,
the same errors and exit codes, the same per-element reports.
"""

import json
import os

import pytest

from primesim_tpu.cli import main as jax_main
from primesim_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNG1 = os.path.join(REPO, "configs", "rung1_64core_fft.json")
SMALL = ["fft_like:n_phases=1,points_per_core=8,seed=3"]
HOST_TIMED = ("wall_s",)  # and each line's value when its unit is MIPS


def _lines(out):
    return [json.loads(ln) for ln in out.strip().splitlines() if ln.startswith("{")]


def _both(args, capsys, rc=0):
    """`primetpu sweep` and the port's (on the CPU) on the same
    arguments: (JAX lines, port lines, JAX stderr, port stderr)."""
    assert jax_main(["sweep", *args]) == rc
    j = capsys.readouterr()
    assert main(["sweep", *args, "--device", "cpu"]) == rc
    t = capsys.readouterr()
    return _lines(j.out), _lines(t.out), j.err, t.err


def _strip(line):
    """A line without its host-timed values: wall seconds, the MIPS made
    from them, and in the obs_timeline line the chunk walls and rates and
    the sequence numbers picked by them (their keys stay)."""
    d = dict(line)
    if d.get("unit") == "MIPS":
        d.pop("value")
    if d["metric"] == "obs_timeline":
        d["detail"] = {
            k: (v if k in ("chunks", "retained", "dropped", "total_steps",
                           "total_instructions")
                else {n: {kk: vv for kk, vv in lab.items() if kk != "wall_s"}
                      for n, lab in v.items()} if k == "labels" else None)
            for k, v in d["detail"].items()
        }
        return d
    d["detail"] = {k: v for k, v in d["detail"].items() if k not in HOST_TIMED}
    return d


def _assert_same_lines(j, t):
    assert [_strip(x) for x in t] == [_strip(x) for x in j]


def _synth_args(specs, *varies, extra=()):
    out = [RUNG1, "--fold", "--chunk-steps", "32"]
    for s in specs:
        out += ["--synth", s]
    for v in varies:
        out += ["--vary", v]
    return out + list(extra)


@pytest.mark.parametrize("case", [
    "varies_with_a_duplicate", "traces_pair_with_varies", "one_vary_replicates", "obs_basic",
])
def test_sweep_lines_match_primetpu_sweep(case, capsys, tmp_path):
    two = SMALL + ["fft_like:n_phases=1,points_per_core=8,seed=4"]
    args = {
        "varies_with_a_duplicate": _synth_args(
            SMALL, "llc_lat=20", "link_lat=2,router_lat=3", "llc_lat=20"),
        "traces_pair_with_varies": _synth_args(two, "quantum=500", "cpi=2"),
        "one_vary_replicates": _synth_args(two, "dram_lat=150"),
        "obs_basic": _synth_args(SMALL, "llc_lat=30", "link_lat=3", extra=[
            "--obs", "basic", "--metrics-out", str(tmp_path / "m.jsonl")]),
    }[case]
    j, t, jerr, terr = _both(args, capsys)
    _assert_same_lines(j, t)
    assert t[-2 if case == "obs_basic" else -1]["metric"] == "fleet_aggregate_MIPS"
    n = {"varies_with_a_duplicate": 3, "obs_basic": 2}.get(case, 2)
    assert [x["detail"]["fleet_index"] for x in t if x["metric"] == "simulated_MIPS"] == \
        list(range(n))
    if case == "varies_with_a_duplicate":
        warn = [ln for ln in terr.splitlines() if "WARNING" in ln]
        assert warn == [ln for ln in jerr.splitlines() if "WARNING" in ln]
        assert warn and "2 duplicates 0" in warn[0]
        assert t[2]["detail"]["dedup_of"] == 0
        assert t[-1]["detail"]["deduplicated"] == [2]
    if case == "obs_basic":
        assert sum(1 for _ in open(tmp_path / "m.jsonl")) > 0


def test_fleet_elements_differ_where_their_knobs_do(capsys):
    _, t, _, _ = _both(_synth_args(SMALL, "llc_lat=10", "llc_lat=40,dram_lat=200"), capsys)
    assert t[1]["detail"]["max_core_cycles"] > t[0]["detail"]["max_core_cycles"]
    assert t[2]["detail"]["instructions"] == sum(x["detail"]["instructions"] for x in t[:2])


@pytest.mark.parametrize("case", ["no_source", "lengths", "all_quarantined"])
def test_fan_rule_errors_match(case, capsys, tmp_path):
    bad = tmp_path / "bad.ptpu"
    bad.write_bytes(b"not a trace")
    args = {
        "no_source": [RUNG1, "--vary", "llc_lat=3"],
        "lengths": _synth_args(SMALL * 2, "llc_lat=1", "llc_lat=2", "llc_lat=3"),
        "all_quarantined": [RUNG1, "--trace", str(bad)],
    }[case]
    if case == "all_quarantined":
        j, t, jerr, terr = _both(args, capsys, rc=1)
        assert "every element was quarantined" in terr and terr.strip() == jerr.strip()
        _assert_same_lines(j, t)
        return
    with pytest.raises(SystemExit) as je:
        jax_main(["sweep", *args])
    with pytest.raises(SystemExit) as te:
        main(["sweep", *args, "--device", "cpu"])
    assert str(te.value) == str(je.value) and str(te.value).startswith("sweep: ")


@pytest.mark.parametrize("spec", ["llc_lat", "llc_latency=3", "llc_lat=x", "quantum=1,=2"])
def test_vary_errors_exit_2_with_the_jax_json(spec, capsys):
    args = _synth_args(SMALL, spec)
    assert jax_main(["sweep", *args]) == 2
    j = capsys.readouterr().err
    assert main(["sweep", *args, "--device", "cpu"]) == 2
    t = capsys.readouterr().err
    assert json.loads(t) == json.loads(j)
    assert json.loads(t)["error"]["type"] == "VarySpecError"


def test_unreadable_trace_is_quarantined(capsys, tmp_path):
    good, bad = tmp_path / "good.ptpu", tmp_path / "bad.ptpu"
    assert main(["synth", SMALL[0], "--cores", "64", "--out", str(good)]) == 0
    bad.write_bytes(b"PTPU" + b"\x00" * 7)
    capsys.readouterr()
    args = [RUNG1, "--trace", str(good), "--trace", str(bad),
            "--trace", str(tmp_path / "missing.ptpu"), "--vary", "llc_lat=5",
            "--chunk-steps", "32"]
    j, t, jerr, terr = _both(args, capsys, rc=3)  # partial success
    _assert_same_lines(j, t)
    assert terr.splitlines()[-1] == jerr.splitlines()[-1] == (
        "sweep: partial — 2 quarantined, 0 stalled of 3 elements")
    status = [x["detail"].get("status") for x in t]
    assert status[:2] == ["quarantined", "quarantined"] and t[-1]["detail"]["quarantined"] == [1, 2]


def test_strict_makes_a_bad_element_fatal(capsys, tmp_path):
    bad = tmp_path / "bad.ptpu"
    bad.write_bytes(b"PTPU" + b"\x00" * 7)
    args = _synth_args([], extra=["--trace", str(bad), "--strict"])
    assert jax_main(["sweep", *args]) == 2
    j = capsys.readouterr().err
    assert main(["sweep", *args, "--device", "cpu"]) == 2
    t = capsys.readouterr().err
    assert json.loads(t) == json.loads(j)


def _report_body(path):
    """The report without the lines that hold the host's wall time."""
    timed = ("host wall seconds", "simulated MIPS", "sim cycles/sec")
    with open(path) as f:
        return [ln for ln in f if not any(x in ln for x in timed)]


def test_report_dir_reports_match(capsys, tmp_path):
    jd, td = tmp_path / "j", tmp_path / "t"
    args = _synth_args(SMALL, "llc_lat=40,dram_lat=200", "quantum=500", "llc_lat=40,dram_lat=200",
                       extra=["--per-core-limit", "4"])
    assert jax_main(["sweep", *args, "--report-dir", str(jd)]) == 0
    assert main(["sweep", *args, "--report-dir", str(td), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        f"element_{i}.txt" for i in range(3)]
    for name in os.listdir(jd):
        assert _report_body(td / name) == _report_body(jd / name), name
    body = "".join(_report_body(td / "element_2.txt"))
    assert "(dedup of 0)" in body and "lat 40" in body


def test_step_impl_is_recorded_and_fault_seed_varies(capsys, tmp_path):
    """--step-impl is recorded in each element's config and changes
    nothing; under a fault schedule --vary fault_seed gives each element
    its own draws, as in `primetpu sweep`."""
    sched = tmp_path / "s.json"
    sched.write_text(json.dumps({"flip_l1": 0.01, "due_rate": 0.5, "due_failstop": True, "events": [
        {"step": 8, "kind": "core_failstop", "core": 3}]}))
    args = _synth_args(SMALL, "fault_seed=1", "fault_seed=2", extra=[
        "--step-impl", "pallas", "--fault-schedule", str(sched), "--fault-seed", "7"])
    j, t, _, _ = _both(args, capsys)
    _assert_same_lines(j, t)
    a, b = ((x["detail"]["instructions"], x["detail"]["max_core_cycles"]) for x in t[:2])
    assert a != b
