"""The port's ground rules: it imports no JAX and nothing of the JAX
package, it refuses to run quietly on the CPU, it names what it does not
support, its traces and reports are the JAX package's own, and its
committed reference fixtures still match the JAX engine.

The fixtures are the rung-1 run in full (`rung1_fft_small.json`) and
digests (`stats/digest.py`) of two full-width runs that chip_smoke.py
holds the card to: the 1024-core headline machine (`headline.json`) and
the shipped rung-3 machine (`rung3_headline.json`), both on the folded
headline trace. Regenerate them all (after a deliberate change of the
simulated model; the two full-width JAX runs take a few minutes on a
CPU) with:
    PYTHONPATH=. python tests/test_torch_rules.py --write-fixture
"""

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import primesim_tpu_torch
from primesim_tpu.config.machine import MachineConfig as JCfg
from primesim_tpu.config.machine import NocConfig as JNoc
from primesim_tpu.config.machine import small_test_config
from primesim_tpu.trace import synth as j_synth
from primesim_tpu.trace.format import fold_ins as j_fold
from primesim_tpu_torch.config.machine import MachineConfig as TCfg
from primesim_tpu_torch.config.machine import PortUnsupportedError
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.trace import synth as t_synth
from primesim_tpu_torch.trace.format import fold_ins as t_fold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(primesim_tpu_torch.__file__)
FIXTURE = os.path.join(PKG, "fixtures", "rung1_fft_small.json")
FULL_WIDTH = ("headline", "rung3_headline")
RUNG1 = os.path.join(REPO, "configs", "rung1_64core_fft.json")


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_and_the_jax_package_out():
    mods = sorted({
        ("primesim_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, "."))
        .removesuffix(".__init__").removesuffix(".__main__")
        for p in _modules()
    })
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'primesim_tpu' or m.startswith('primesim_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr


def test_no_module_of_the_port_imports_jax():
    for path in _modules():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "primesim_tpu"), (path, n)


def _tiny():
    j = small_test_config(8, n_banks=4, quantum=300)
    return TCfg.from_json(j.to_json()), t_synth.false_sharing(8, n_mem_ops=8, seed=1)


def test_engine_without_a_card_or_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, tr = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, tr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, tr, device="cuda")
    Engine(cfg, tr, device="cpu").run()


@pytest.mark.parametrize(
    "field,kw",
    [
        ("faults_enabled", dict(faults_enabled=True)),
        ("prefetcher", dict(prefetcher="stride")),
        ("coherence", dict(coherence="moesi")),
        ("sharer_group", dict(sharer_group=2)),
        ("sharer_chunk_words", dict(sharer_chunk_words=1)),
        ("noc.topology", dict(noc=JNoc(mesh_x=2, mesh_y=2, topology="torus"))),
    ],
)
def test_unsupported_fields_raise(field, kw):
    cfg = TCfg.from_json(small_test_config(8, n_banks=4, **kw).to_json())
    _, tr = _tiny()
    with pytest.raises(PortUnsupportedError) as e:
        Engine(cfg, tr, device="cpu")
    assert e.value.field == field


def test_step_impl_and_pallas_reduce_are_accepted():
    j = small_test_config(8, n_banks=4, step_impl="pallas", pallas_reduce=True)
    _, tr = _tiny()
    Engine(TCfg.from_json(j.to_json()), tr, device="cpu").run()


def test_shipped_configs_load_unchanged():
    import glob

    machines = [
        p for p in sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
        if os.path.basename(p).startswith(("rung", "zoo_"))
    ]
    assert len(machines) == 7
    for p in machines:
        with open(p) as f:
            s = f.read()
        assert TCfg.from_json(s).to_json() == JCfg.from_json(s).to_json(), p


@pytest.mark.parametrize("gen", sorted(j_synth.GENERATORS))
def test_synth_traces_are_byte_identical(gen):
    for n in (8, 64):
        j = j_synth.GENERATORS[gen](n, seed=5)
        t = t_synth.GENERATORS[gen](n, seed=5)
        assert j.events.tobytes() == t.events.tobytes()
        assert j.lengths.tobytes() == t.lengths.tobytes()
        assert j_fold(j).events.tobytes() == t_fold(t).events.tobytes()


def _report_body(path):
    """The report without the lines that hold the host's wall time."""
    timed = ("host wall seconds", "simulated MIPS", "sim cycles/sec")
    with open(path) as f:
        return [ln for ln in f if not any(t in ln for t in timed)]


def test_cli_writes_the_jax_report(tmp_path):
    from primesim_tpu.cli import main as jax_main

    spec = "fft_like:n_phases=1,points_per_core=8,seed=3"
    j_rep, t_rep = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jax_main(
        ["run", RUNG1, "--synth", spec, "--fold", "--engine", "jax",
         "--report", str(j_rep)]
    ) == 0
    r = subprocess.run(
        [sys.executable, "-m", "primesim_tpu_torch", "run", RUNG1, "--synth",
         spec, "--fold", "--device", "cpu", "--report", str(t_rep)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["detail"]["engine"] == "torch"
    assert _report_body(t_rep) == _report_body(j_rep)
    assert len(_report_body(t_rep)) > 20


def test_cli_without_a_card_refuses(monkeypatch):
    from primesim_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", RUNG1, "--synth", "stream:n_mem_ops=4"])


def fixture_from_engine(eng) -> dict:
    """What the rung-1 reference fixture records of a finished run."""
    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(np.asarray(a), np.int32).tobytes()).hexdigest()

    l1, dirm = eng.state.l1, eng.state.dirm
    if hasattr(l1, "cpu"):
        l1, dirm = l1.cpu().numpy(), dirm.cpu().numpy()
    return {
        "cycles": [int(x) for x in eng.cycles],
        "counters": {k: [int(x) for x in v] for k, v in eng.counters.items()},
        "l1_sha256": sha(l1),
        "dirm_sha256": sha(dirm),
    }


def _fixture_run_jax():
    from primesim_tpu.sim.engine import Engine as JEngine

    fx = json.load(open(FIXTURE))
    with open(os.path.join(REPO, fx["config"])) as f:
        cfg = JCfg.from_json(f.read())
    tr = j_synth.GENERATORS[fx["trace"]["generator"]](**fx["trace"]["args"])
    eng = JEngine(cfg, tr, chunk_steps=fx["chunk_steps"])
    eng.run()
    return fx, eng


def test_rung1_fixture_matches_the_jax_engine():
    fx, eng = _fixture_run_jax()
    got = fixture_from_engine(eng)
    for k in ("cycles", "counters", "l1_sha256", "dirm_sha256"):
        assert got[k] == fx[k], k
    assert fx["steps"] == eng.steps_run


def test_rung1_fixture_matches_the_port_on_cpu():
    fx = json.load(open(FIXTURE))
    with open(os.path.join(REPO, fx["config"])) as f:
        cfg = TCfg.from_json(f.read())
    tr = t_synth.GENERATORS[fx["trace"]["generator"]](**fx["trace"]["args"])
    eng = Engine(cfg, tr, chunk_steps=fx["chunk_steps"], device="cpu")
    eng.run()
    got = fixture_from_engine(eng)
    for k in ("cycles", "counters", "l1_sha256", "dirm_sha256"):
        assert got[k] == fx[k], k


def _full_width(name):
    """The JAX engine's run of a full-width fixture's machine and trace."""
    from primesim_tpu.sim.engine import Engine as JEngine

    with open(os.path.join(PKG, "fixtures", f"{name}.json")) as f:
        fx = json.load(f)
    spec = fx["config"]
    if isinstance(spec, str):
        with open(os.path.join(REPO, spec)) as f:
            spec = json.load(f)
    tr = j_synth.GENERATORS[fx["trace"]["generator"]](**fx["trace"]["args"])
    if fx["trace"].get("fold"):
        tr = j_fold(tr)
    eng = JEngine(JCfg.from_dict(spec), tr, chunk_steps=fx["chunk_steps"])
    eng.run()
    return fx, eng


def digest_of_jax_engine(eng) -> dict:
    from primesim_tpu_torch.stats.digest import run_digest

    return run_digest(
        eng.steps_run, eng.cycles, eng.counters,
        np.asarray(eng.state.link_free), np.asarray(eng.state.dram_free),
    )


@pytest.mark.slow  # two 1024-core JAX runs of 1536 and 2560 steps
@pytest.mark.parametrize("name", FULL_WIDTH)
def test_full_width_digests_match_the_jax_engine(name):
    fx, eng = _full_width(name)
    assert digest_of_jax_engine(eng) == fx["digest"]


def write_fixtures():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from primesim_tpu.sim.engine import Engine as JEngine

    spec = {
        "config": "configs/rung1_64core_fft.json",
        "trace": {
            "generator": "fft_like",
            "args": {"n_cores": 64, "n_phases": 2, "points_per_core": 32, "seed": 7},
        },
        "chunk_steps": 64,
    }
    with open(os.path.join(REPO, spec["config"])) as f:
        cfg = JCfg.from_json(f.read())
    eng = JEngine(cfg, j_synth.fft_like(**spec["trace"]["args"]), chunk_steps=64)
    eng.run()
    spec["steps"] = eng.steps_run
    spec.update(fixture_from_engine(eng))
    with open(FIXTURE, "w") as f:
        json.dump(spec, f)
        f.write("\n")
    print(f"wrote {FIXTURE}: {eng.steps_run} steps")

    # bench.py's headline machine and trace, and the shipped rung-3
    # machine on the same trace
    trace = {
        "generator": "fft_like",
        "args": {"n_cores": 1024, "n_phases": 4, "points_per_core": 256,
                 "ins_per_mem": 8, "seed": 42},
        "fold": True,
    }
    headline = {
        "n_cores": 1024, "n_banks": 1024,
        "l1": {"size": 32768, "ways": 4, "line": 64, "latency": 2},
        "llc": {"size": 262144, "ways": 8, "line": 64, "latency": 10},
        "noc": {"mesh_x": 32, "mesh_y": 32, "link_lat": 1, "router_lat": 1},
        "dram_lat": 100, "quantum": 1000, "local_run_len": 8,
    }
    configs = {"headline": headline,
               "rung3_headline": "configs/rung3_1024core_o3.json"}
    for name in FULL_WIDTH:
        path = os.path.join(PKG, "fixtures", f"{name}.json")
        with open(path, "w") as f:
            json.dump({"config": configs[name], "trace": trace,
                       "chunk_steps": 512, "digest": None}, f)
        fx, eng = _full_width(name)
        fx["digest"] = digest_of_jax_engine(eng)
        with open(path, "w") as f:
            json.dump(fx, f, indent=1)
            f.write("\n")
        print(f"wrote {path}: {eng.steps_run} steps")


if __name__ == "__main__" and sys.argv[1:] == ["--write-fixture"]:
    write_fixtures()
