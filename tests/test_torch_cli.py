"""The port's command line (`python -m primesim_tpu_torch`) against
`primetpu`, on the CPU.

XML configs (`config/xml_compat.py`) load to the JAX loader's configs and
refuse the same files with the same messages (mirroring
tests/test_checkpoint.py's xml_compat tests). `run` prints `primetpu
run`'s summary key for key (the engine's name, the host's wall time and
the MIPS made from it excepted; the port adds its device and step count)
on JSON and XML configs, with and without `--obs`, and writes the same
report under `--per-core-limit`; `--debug-invariants` passes a clean run
and stops a corrupted one. `synth` writes `primetpu synth`'s bytes for
every generator, `info` prints its text for every shipped machine config.
The flag combinations `primetpu run` refuses are refused with its
messages, and a synth spec with an empty `k=v` pair exits as it does.
"""

import json
import os
import subprocess
import sys

import pytest

from primesim_tpu.cli import main as jax_main
from primesim_tpu.config import xml_compat as j_xml
from primesim_tpu.trace import synth as j_synth
from primesim_tpu_torch.cli import main
from primesim_tpu_torch.config import xml_compat as t_xml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNG1 = os.path.join(REPO, "configs", "rung1_64core_fft.json")
XML = os.path.join(REPO, "configs", "example_prime.xml")
MACHINES = sorted(
    f for f in os.listdir(os.path.join(REPO, "configs"))
    if f.startswith(("rung", "zoo_")) or f.endswith(".xml")
)
SPEC = "fft_like:n_phases=1,points_per_core=8,ins_per_mem=4,seed=3"
HOST_TIMED = ("wall_s",)  # besides value (MIPS), engine and the port's own keys


def _summary(out):
    return json.loads(out.strip().splitlines()[-1])


def _both(args, capsys):
    """`primetpu` and the port (on the CPU) on the same arguments: their
    summary lines."""
    assert jax_main(args) == 0
    j = _summary(capsys.readouterr().out)
    assert main(args + ["--device", "cpu"]) == 0
    t = _summary(capsys.readouterr().out)
    return j, t


def _assert_same_summary(j, t):
    assert (t["metric"], t["unit"]) == (j["metric"], j["unit"])
    jd, td = j["detail"], t["detail"]
    assert td["engine"] == "torch" and td["device"] == "cpu" and td["steps"] > 0
    assert set(td) - {"device", "steps"} == set(jd)
    for k in set(jd) - {"engine", "timeline", *HOST_TIMED}:
        assert td[k] == jd[k], k
    if "timeline" in jd:
        assert set(td["timeline"]) == set(jd["timeline"])
        assert td["timeline"]["chunks"] == jd["timeline"]["chunks"]


# ---- XML ------------------------------------------------------------------


def test_example_prime_xml_loads_to_the_jax_config():
    t, j = t_xml.load_xml(XML), j_xml.load_xml(XML)
    assert t.to_json() == j.to_json()
    assert t.n_cores == 64 and t.llc.size == 262144 and t.local_run_len == 0


def test_xml_aliases_and_errors_match_load_xml(tmp_path):
    p = tmp_path / "alias.xml"
    p.write_text(
        """<sim><sys>
        <n_cores>8</n_cores>
        <quantum>500</quantum>
        <dram_latency>90</dram_latency>
        <network><x_dimension>2</x_dimension><y_dimension>2</y_dimension>
        </network>
        <cache level="1"><size>1024</size><associativity>2</associativity>
          <line_size>64</line_size><latency>2</latency></cache>
        <cache level="2" shared="yes" num_banks="4"><size>8192</size>
          <num_ways>4</num_ways><line_size>64</line_size>
          <access_time>11</access_time></cache>
        </sys></sim>"""
    )
    cfg = t_xml.load_xml(str(p))
    assert cfg.to_json() == j_xml.load_xml(str(p)).to_json()
    assert cfg.n_cores == 8 and cfg.quantum == 500 and cfg.dram_lat == 90
    assert cfg.l1.ways == 2 and cfg.llc.latency == 11 and cfg.n_banks == 4
    bad = {
        "no_cache": "<sim><sys><num_cores>8</num_cores></sys></sim>",
        "no_shared": '<sim><sys><num_cores>8</num_cores><cache level="1"><size>1024'
                     "</size></cache></sys></sim>",
        "two_shared": '<sim><sys><cache shared="true"/><cache shared="true"/></sys></sim>',
        "no_cores": '<sim><sys><cache level="1"><size>1024</size><num_ways>2</num_ways>'
                    "<line_size>64</line_size><latency>2</latency></cache>"
                    '<cache level="2" shared="1"><size>8192</size><num_ways>4</num_ways>'
                    "<line_size>64</line_size><latency>9</latency></cache></sys></sim>",
        "no_l1_ways": '<sim><sys><num_cores>8</num_cores><cache level="1"><size>1024'
                      '</size></cache><cache level="2" shared="true"><size>8192</size>'
                      "</cache></sys></sim>",
    }
    for name, text in bad.items():
        f = tmp_path / f"{name}.xml"
        f.write_text(text)
        with pytest.raises(ValueError) as je:
            j_xml.load_xml(str(f))
        with pytest.raises(ValueError) as te:
            t_xml.load_xml(str(f))
        assert str(te.value) == str(je.value), name


# ---- run ------------------------------------------------------------------


@pytest.mark.parametrize("config", ["json", "xml", "json_obs_full", "xml_step_impl"])
def test_run_summary_matches_primetpu_run(config, capsys, tmp_path):
    args = ["run", XML if config.startswith("xml") else RUNG1, "--synth", SPEC,
            "--fold", "--chunk-steps", "32"]
    if config == "json_obs_full":
        args += ["--obs", "full", "--metrics-out", str(tmp_path / "m.jsonl")]
    if config == "xml_step_impl":
        args += ["--step-impl", "pallas"]
    j, t = _both(args, capsys)
    _assert_same_summary(j, t)
    if config == "json_obs_full":
        assert t["detail"]["timeline"]["chunks"] == t["detail"]["steps"] // 32
    if config == "xml_step_impl":
        assert t["detail"]["step_impl"] == "pallas"


def _report_body(path):
    """The report without the lines that hold the host's wall time."""
    timed = ("host wall seconds", "simulated MIPS", "sim cycles/sec")
    with open(path) as f:
        return [ln for ln in f if not any(s in ln for s in timed)]


def _labels(path):
    """The report's lines cut before their first digit (TIMELINE values are
    host-timed; their labels are not)."""
    with open(path) as f:
        return [ln.split(next((c for c in ln if c.isdigit()), "\n"))[0].rstrip() for ln in f]


@pytest.mark.parametrize("obs", ["off", "basic"])
def test_per_core_limit_report_matches_primetpu_run(obs, capsys, tmp_path):
    reps = tmp_path / "j.txt", tmp_path / "t.txt"
    base = ["run", RUNG1, "--synth", SPEC, "--fold", "--per-core-limit", "16",
            "--obs", obs]
    assert jax_main(base + ["--report", str(reps[0])]) == 0
    assert main(base + ["--report", str(reps[1]), "--device", "cpu"]) == 0
    capsys.readouterr()
    if obs == "off":
        body = _report_body(reps[1])
        assert body == _report_body(reps[0])
        assert "PER-CORE (first 16 of 64)\n" in body
        assert not any("TIMELINE" in ln for ln in body)
    else:
        labels = _labels(reps[1])
        assert labels == _labels(reps[0])
        assert any("TIMELINE" in ln for ln in labels)


def test_debug_invariants_pass_clean_and_stop_a_corrupted_run(capsys, monkeypatch):
    from primesim_tpu_torch.sim import engine

    args = ["run", XML, "--synth", "fft_like:n_phases=2", "--fold", "--debug-invariants"]
    j, t = _both(args, capsys)
    _assert_same_summary(j, t)
    real = engine.run_chunk

    def corrupting(cfg, n, events, st, *a, **kw):
        st = real(cfg, n, events, st, *a, **kw)
        st.dirm[0, 1] = cfg.n_cores + 5  # an owner that is no core
        return st

    monkeypatch.setattr(engine, "run_chunk", corrupting)
    with pytest.raises(AssertionError, match="llc_owner out of range"):
        main(args + ["--device", "cpu", "--max-steps", "64", "--chunk-steps", "32"])


def test_xprof_writes_a_profiler_trace(capsys, tmp_path):
    d = tmp_path / "prof"
    assert main(["run", RUNG1, "--synth", "stream:n_mem_ops=4", "--xprof", str(d),
                 "--device", "cpu"]) == 0
    assert "profiler trace written" in capsys.readouterr().err
    assert json.load(open(d / "trace.json"))["traceEvents"]


@pytest.mark.parametrize("extra", [
    ["--trace-out", "@t.json"], ["--obs", "basic", "--trace-out", "@t.json"],
    ["--metrics-out", "@m.jsonl"], ["--obs", "full", "--xprof", "@prof"],
])
def test_refused_flag_combinations_match_primetpu(extra, tmp_path):
    args = ["run", RUNG1, "--synth", "stream:n_mem_ops=4",
            *[str(tmp_path / a[1:]) if a[0] == "@" else a for a in extra]]
    with pytest.raises(SystemExit) as je:
        jax_main(args)
    with pytest.raises(SystemExit) as te:
        main(args + ["--device", "cpu"])
    assert str(te.value) == str(je.value) and "--" in str(te.value)


@pytest.mark.parametrize("spec", [
    "fft_like:n_phases=2,", "fft_like:,n_phases=2", "fft_like:n_phases", "fft_like:=2",
    "fft_like:n_phases=x", "nonesuch", "fft_like:bogus=1",
])
def test_bad_synth_specs_exit_as_primetpu(spec, tmp_path):
    """Satellite repair: an empty `k=v` pair is refused (the port used to
    drop it), with primetpu's message."""
    args = ["synth", spec, "--cores", "8", "--out", str(tmp_path / "x.ptpu")]
    with pytest.raises(SystemExit) as je:
        jax_main(args)
    with pytest.raises(SystemExit) as te:
        main(args)
    assert str(te.value) == str(je.value)
    if spec.endswith(","):
        assert str(te.value) == "bad synth arg '' (want key=value)"


# ---- synth and info -------------------------------------------------------


@pytest.mark.parametrize("gen", sorted(j_synth.GENERATORS))
def test_synth_files_are_byte_identical(gen, tmp_path, capsys):
    for fold in ([], ["--fold"]):
        jp, tp = tmp_path / f"j{len(fold)}.ptpu", tmp_path / f"t{len(fold)}.ptpu"
        assert jax_main(["synth", f"{gen}:seed=7", "--cores", "16", "--out", str(jp), *fold]) == 0
        j_err = capsys.readouterr().err
        assert main(["synth", f"{gen}:seed=7", "--cores", "16", "--out", str(tp), *fold]) == 0
        assert capsys.readouterr().err.replace(str(tp), "P") == j_err.replace(str(jp), "P")
        assert tp.read_bytes() == jp.read_bytes()


@pytest.mark.parametrize("config", MACHINES)
def test_info_prints_primetpus_text(config, capsys):
    path = os.path.join(REPO, "configs", config)
    assert jax_main(["info", path]) == 0
    j = capsys.readouterr().out
    assert main(["info", path]) == 0
    assert capsys.readouterr().out == j
    assert json.loads(j)["n_cores"] > 0


def test_module_entry_point_runs_info():
    r = subprocess.run([sys.executable, "-m", "primesim_tpu_torch", "info", XML],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and json.loads(r.stdout)["n_cores"] == 64
