"""The port's knob calibration (`primesim_tpu_torch/calib/`, the
`calibrate` verb) against the JAX package's `calib/`, on the CPU,
mirroring the calibration cases of tests/test_zoo.py.

Every malformed table the JAX tests name raises `CalibError` with the
same message and location in both packages. On the JAX tests' two-entry
self-test table and 8-core machine, `simulate_matrix` at three DRAM
latencies and a whole `fit` to ground-truth knobs give the JAX package's
floats exactly (the metrics, residuals and costs are computed from
integers in the same order), and the fitted knobs round-trip into a
loadable config. The verb prints `primetpu calibrate`'s lines and exits 2
with `primetpu`'s error line on a bad table or fit key.
"""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from primesim_tpu.calib.table import CalibEntry as JEntry
from primesim_tpu.calib.table import CalibError as JCalibError
from primesim_tpu.calib.table import CalibTable as JTable
from primesim_tpu.calib.table import parse_table as j_parse
from primesim_tpu.cli import main as j_main
from primesim_tpu.config.machine import small_test_config as j_small
from primesim_tpu_torch.calib import CalibEntry, CalibError, CalibTable
from primesim_tpu_torch.calib.table import parse_table
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.config.machine import MachineConfig
from primesim_tpu_torch.config.machine import small_test_config

# the packages re-export a function named `fit`: take the modules
JF = importlib.import_module("primesim_tpu.calib.fit")
TF = importlib.import_module("primesim_tpu_torch.calib.fit")

TRUTH = {"llc_lat": 16, "dram_lat": 151}


def _table(Entry, Table):
    return Table(
        name="selftest",
        entries=(
            Entry("chase", "pointer_chase", {"n_mem_ops": 48, "n_nodes": 16},
                  "cycles_per_mem_op", 1.0),
            Entry("xchg", "uniform_random", {"n_mem_ops": 48, "shared_frac": 1, "seed": 1},
                  "cycles_per_mem_op", 1.0),
        ),
    )


def _cfgs():
    return (j_small(8, n_banks=4, quantum=500), small_test_config(8, n_banks=4, quantum=500))


@pytest.mark.parametrize(
    "mutate,entry,field",
    [
        (lambda t: t["entries"][0].update(generator="nope"), "e0", "generator"),
        (lambda t: t["entries"][0].update(metric="mips"), "e0", "metric"),
        (lambda t: t["entries"][0].update(observed=0), "e0", "observed"),
        (lambda t: t["entries"][0]["params"].update(n_mem_ops=1.5), "e0", "params"),
        (lambda t: t["entries"].append(dict(t["entries"][0])), "e0", None),
        (lambda t: t.pop("name"), None, "name"),
        (lambda t: t.update(entries=[]), None, "entries"),
    ],
    ids=["generator", "metric", "observed", "params", "duplicate", "name", "entries"],
)
def test_table_errors_are_the_jax_package_s(mutate, entry, field):
    t = {
        "name": "tbl",
        "entries": [{
            "name": "e0", "generator": "stream",
            "params": {"n_mem_ops": 32}, "metric": "total_cycles",
            "observed": 10.0,
        }],
    }
    mutate(t)
    text = json.dumps(t)
    with pytest.raises(JCalibError) as want:
        j_parse(text)
    with pytest.raises(CalibError) as got:
        parse_table(text)
    assert str(got.value) == str(want.value)
    assert got.value.location() == want.value.location()
    loc = got.value.location()
    if entry is not None:
        assert loc.get("entry") == entry
    if field is not None:
        assert loc.get("field") == field


def test_shipped_table_parses_as_in_the_jax_package():
    with open("configs/calib_ipu_microbench.json") as f:
        text = f.read()
    assert repr(parse_table(text)) == repr(j_parse(text))


def test_simulate_matrix_equals_the_jax_package_s():
    jc, tc = _cfgs()
    knob_sets = [{"dram_lat": 50}, {"dram_lat": 100}, {"dram_lat": 200}]
    want = JF.simulate_matrix(jc, _table(JEntry, JTable), knob_sets, chunk_steps=64)
    got = TF.simulate_matrix(tc, _table(CalibEntry, CalibTable), knob_sets, chunk_steps=64,
                             device="cpu")
    assert got == want
    for e in range(2):  # monotone in the DRAM latency
        col = [got[k][e] for k in range(3)]
        assert col[0] < col[1] < col[2]


def test_fit_recovers_the_truth_as_the_jax_package_does():
    jc, tc = _cfgs()
    jt = JF.synthesize_observed(jc, _table(JEntry, JTable), TRUTH, chunk_steps=64)
    want = JF.fit(jc, jt, fit_keys=tuple(TRUTH), chunk_steps=64)
    tt = TF.synthesize_observed(tc, _table(CalibEntry, CalibTable), TRUTH, chunk_steps=64,
                                device="cpu")
    ev = TF._FleetEvaluator(tc, tt, TF.build_traces(tc, tt), 64, "cpu")
    got = TF.fit(tc, tt, fit_keys=tuple(TRUTH), chunk_steps=64, evaluator=ev)
    assert got.report() == want.report()
    assert got.knobs == TRUTH and got.cost == 0.0 and got.batch == 5 * 2
    assert ev.runs == got.fleet_runs and ev.steps > 0
    # the fitted knobs round-trip into a loadable machine config
    out = TF.apply_fit(tc, got.knobs)
    assert out.llc.latency == 16 and out.dram_lat == 151
    assert MachineConfig.from_dict(json.loads(out.to_json())) == out
    assert out.to_json() == JF.apply_fit(jc, want.knobs).to_json()


def test_apply_fit_writes_every_fittable_knob_as_the_jax_package_does():
    jc, tc = _cfgs()
    knobs = {k: 3 + i for i, k in enumerate(sorted(TF._KNOB_READERS))}
    out = TF.apply_fit(tc, knobs)
    assert out.to_json() == JF.apply_fit(jc, knobs).to_json()
    assert MachineConfig.from_dict(json.loads(out.to_json())) == out
    assert TF.knob_start(out, tuple(knobs)) == knobs


def _cli_error(fn, argv, capsys):
    rc = fn(argv)
    return rc, json.loads(capsys.readouterr().err.strip().splitlines()[-1])


def test_calibrate_typed_errors_exit_2_with_primetpu_s_line(tmp_path, capsys):
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(small_test_config(4).to_json())
    bad = tmp_path / "bad.json"
    bad.write_text('{"name": "t", "entries": [{"name": "x"}]}')
    good = tmp_path / "tbl.json"
    good.write_text(json.dumps({
        "name": "t",
        "entries": [{"name": "x", "generator": "stream", "params": {"n_mem_ops": 32},
                     "metric": "total_cycles", "observed": 10.0}],
    }))
    for argv, where in (
        (["calibrate", str(cfg_path), "--table", str(bad)],
         {"entry": "x", "field": "generator"}),
        (["calibrate", str(cfg_path), "--table", str(good), "--fit", "warp_speed"],
         {"field": "fit"}),
        (["calibrate", str(cfg_path), "--table", str(tmp_path / "none.json")], {}),
    ):
        want = _cli_error(j_main, argv, capsys)
        got = _cli_error(main, argv + ["--device", "cpu"], capsys)
        assert got == want
        assert got[0] == 2 and got[1]["error"]["type"] == "CalibError"
        assert got[1]["error"]["location"] == where


def test_calibrate_prints_primetpu_s_lines(tmp_path, capsys):
    """The verb's self-test on the 8-core machine (one round cap) prints
    `primetpu calibrate`'s residual and fit lines, the wall aside, writes
    its report with the fitted config, exits as it does, and adds the
    port's stderr line."""
    jc, _ = _cfgs()
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(jc.to_json())
    tbl = tmp_path / "t.json"
    tbl.write_text(json.dumps({"name": "selftest", "entries": [
        {"name": e.name, "generator": e.generator, "params": e.params,
         "metric": e.metric, "observed": e.observed}
        for e in _table(JEntry, JTable).entries]}))
    argv = ["calibrate", str(cfg_path), "--table", str(tbl), "--fit", "llc_lat,dram_lat",
            "--selftest", "--truth", "llc_lat=16,dram_lat=151", "--chunk-steps", "64",
            "--rounds", "1", "--out"]

    def lines(fn, extra, out):
        rc = fn(argv + [str(out)] + extra)
        cap = capsys.readouterr()
        rows = [json.loads(ln) for ln in cap.out.splitlines()]
        rows[-1]["detail"].pop("wall_s")
        return rc, rows, json.loads(out.read_text()), cap.err

    j_rc, j_rows, j_rep, _ = lines(j_main, [], tmp_path / "j.json")
    rc, rows, rep, err = lines(main, ["--device", "cpu"], tmp_path / "t_out.json")
    assert (rc, rows) == (j_rc, j_rows)
    assert rep == j_rep
    assert rc == 1  # one round does not reach the truth: the self-test fails
    [dev] = [ln for ln in err.splitlines() if ln.startswith("calibrate: device cpu, ")]
    stats = json.loads(dev.partition(", ")[2])
    assert stats["fleet_runs"] == rows[-1]["detail"]["fleet_runs"] and stats["fleet_steps"] > 0


def test_calibrate_without_a_card_or_a_device_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(small_test_config(4).to_json())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["calibrate", str(cfg_path), "--table", "configs/calib_ipu_microbench.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.simulate_matrix(small_test_config(4), _table(CalibEntry, CalibTable), [{}])
