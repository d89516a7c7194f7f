"""The port's ground rules: it imports no JAX and nothing of the JAX
package, it refuses to run quietly on the CPU, it names what it does not
support, its traces and reports are the JAX package's own, and its
committed reference fixtures still match the JAX engine.

The fixtures are the rung-1 run in full (`rung1_fft_small.json`) and
digests (`stats/digest.py`) of seven full-width runs that chip_smoke.py
holds the card to: the 1024-core headline machine (`headline.json`) and
the shipped rung-3 machine (`rung3_headline.json`), both on the folded
headline trace, and the shipped rung-4 (4096 cores, chunked full map)
and rung-5 (16384 cores, coarse sharer vector) machines at full geometry
on folded fft_like traces of their own widths (`rung4_full.json`,
`rung5_full.json`); the machine zoo's shipped 16-core torus/MOESI/stride
machine (`zoo_smoke.json`) and 1472-tile IPU profile (`ipu_full.json`,
a bulk-synchronous barrier trace), and the headline machine under MOESI
(`headline_moesi.json`). Regenerate them (after a deliberate change of
the simulated model) with:
    PYTHONPATH=. python tests/test_torch_rules.py --write-fixture [name ...]
naming the full-width fixtures to rewrite, or none for all of them and
the rung-1 run. The JAX runs take seconds to a few minutes each on a
CPU, and the large ones several to tens of GB of host memory.
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
FULL_WIDTH = ("headline", "rung3_headline", "rung4_full", "rung5_full",
              "zoo_smoke", "ipu_full", "headline_moesi")
SMALL_WIDTH = ("zoo_smoke",)  # its JAX run is quick enough for tier 1
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
    ],
)
def test_unsupported_fields_raise(field, kw):
    cfg = TCfg.from_json(small_test_config(8, n_banks=4, **kw).to_json())
    _, tr = _tiny()
    with pytest.raises(PortUnsupportedError) as e:
        Engine(cfg, tr, device="cpu")
    assert e.value.field == field


@pytest.mark.parametrize(
    "kw",
    [dict(prefetcher="stride"), dict(coherence="moesi"),
     dict(noc=JNoc(mesh_x=2, mesh_y=2, topology="torus"))],
    ids=["prefetcher", "coherence", "noc.topology"],
)
def test_zoo_fields_are_accepted(kw):
    """The machine zoo's selectors run in the port, to the JAX engine's
    cycles and counters."""
    from primesim_tpu.sim.engine import Engine as JEngine

    j = small_test_config(8, n_banks=4, quantum=300, **kw)
    _, tr = _tiny()
    te = Engine(TCfg.from_json(j.to_json()), tr, chunk_steps=32, device="cpu")
    te.run()
    te.verify_invariants()
    je = JEngine(j, tr, chunk_steps=32)
    je.run()
    np.testing.assert_array_equal(te.cycles, je.cycles)
    for k, v in je.counters.items():
        np.testing.assert_array_equal(te.counters[k], v, err_msg=k)


@pytest.mark.parametrize(
    "kw",
    [dict(sharer_group=2), dict(sharer_group=8), dict(sharer_chunk_words=1),
     dict(sharer_group=2, sharer_chunk_words=1)],
    ids=["sharer_group=2", "sharer_group=8", "sharer_chunk_words=1", "both"],
)
def test_coarse_and_chunked_directories_are_accepted(kw):
    """The coarse sharer vector and the chunked full map run in the port,
    to the JAX engine's cycles and counters."""
    from primesim_tpu.sim.engine import Engine as JEngine

    j = small_test_config(8, n_banks=4, quantum=300, **kw)
    _, tr = _tiny()
    te = Engine(TCfg.from_json(j.to_json()), tr, chunk_steps=32, device="cpu")
    te.run()
    te.verify_invariants()
    je = JEngine(j, tr, chunk_steps=32)
    je.run()
    np.testing.assert_array_equal(te.cycles, je.cycles)
    for k, v in je.counters.items():
        np.testing.assert_array_equal(te.counters[k], v, err_msg=k)


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


@pytest.mark.parametrize(
    "kw",
    [dict(n_cores=1), dict(n_cores=3, n_phases=5, points_per_core=7, ins_per_mem=0, line=32),
     dict(n_cores=100, n_phases=3, points_per_core=9, ins_per_mem=1, line=8, seed=3),
     dict(n_cores=256, n_phases=8, points_per_core=16, ins_per_mem=8, seed=42)],
    ids=["1core", "no_ins", "100cores", "256cores_8phases"],
)
def test_fft_like_and_its_fold_are_byte_identical(kw):
    """The port builds fft_like and folds traces with whole-array numpy;
    the JAX package loops event by event. Odd core counts, no INS, short
    lines and eight phases give the same bytes."""
    j, t = j_synth.fft_like(**kw), t_synth.fft_like(**kw)
    assert j.events.tobytes() == t.events.tobytes()
    assert j.lengths.tobytes() == t.lengths.tobytes()
    jf, tf = j_fold(j), t_fold(t)
    assert jf.events.tobytes() == tf.events.tobytes()
    assert jf.lengths.tobytes() == tf.lengths.tobytes()


def test_fold_keeps_a_last_batch_like_the_jax_package():
    from primesim_tpu.trace.format import EV_BARRIER, EV_INS, EV_LD, EV_ST
    from primesim_tpu.trace.format import Trace as JTrace
    from primesim_tpu.trace.format import from_event_lists as j_events
    from primesim_tpu_torch.trace.format import Trace as TTrace

    def both(evs):
        j = j_events(evs)
        return [fold(cls(j.events, j.lengths, line_addressed=True))
                for fold, cls in ((j_fold, JTrace), (t_fold, TTrace))]

    jf, tf = both([
        [(EV_INS, 5, 0), (EV_LD, 4, 64), (EV_INS, 3, 0)],  # a batch before END
        [],
        [(EV_INS, 2**30, 0), (EV_INS, 2**29, 0), (EV_ST, 4, 0, 7)],
        [(EV_BARRIER, 1, 0), (EV_INS, 1, 0), (EV_INS, 2, 0)],
    ])
    assert tf.events.tobytes() == jf.events.tobytes()
    assert tf.lengths.tobytes() == jf.lengths.tobytes() and tf.line_addressed
    # a batch whose fold overflows int32 is refused by both
    j = j_events([[(EV_INS, 2**30, 0), (EV_INS, 2**30, 0), (EV_LD, 4, 0)]])
    for fold, cls in ((j_fold, JTrace), (t_fold, TTrace)):
        with pytest.raises(ValueError, match="must be >= 0"):
            fold(cls(j.events, j.lengths))


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


@pytest.mark.parametrize(
    "name",
    [n if n in SMALL_WIDTH
     else pytest.param(n, marks=pytest.mark.slow)  # 1024- to 16384-core JAX runs
     for n in FULL_WIDTH],
)
def test_full_width_digests_match_the_jax_engine(name):
    fx, eng = _full_width(name)
    assert digest_of_jax_engine(eng) == fx["digest"]


def _folded(generator, **args):
    return {"generator": generator, "args": {**args, "seed": 42}, "fold": True}


def _folded_fft(n_cores, n_phases, points_per_core, ins_per_mem=8):
    return _folded("fft_like", n_cores=n_cores, n_phases=n_phases,
                   points_per_core=points_per_core, ins_per_mem=ins_per_mem)


# bench.py's headline machine
HEADLINE = {
    "n_cores": 1024, "n_banks": 1024,
    "l1": {"size": 32768, "ways": 4, "line": 64, "latency": 2},
    "llc": {"size": 262144, "ways": 8, "line": 64, "latency": 10},
    "noc": {"mesh_x": 32, "mesh_y": 32, "link_lat": 1, "router_lat": 1},
    "dram_lat": 100, "quantum": 1000, "local_run_len": 8,
}
# (machine, trace) of each full-width fixture: bench.py's headline machine
# and the shipped rung-3 machine on bench.py's headline trace; rungs 4 and
# 5 as shipped, on traces of their widths (rung 5's eight phases reach
# partners 64 and 128 cores away, across its 64-core sharer groups); the
# machine zoo's two shipped configs, the CI smoke machine on CI's trace
# and the 1472-tile IPU profile on a bulk-synchronous trace (its first
# card path with barriers); the headline machine under MOESI
FULL_WIDTH_SPECS = {
    "headline": (HEADLINE, _folded_fft(1024, 4, 256)),
    "rung3_headline": ("configs/rung3_1024core_o3.json", _folded_fft(1024, 4, 256)),
    "rung4_full": ("configs/rung4_4096core_biglittle.json", _folded_fft(4096, 4, 128)),
    "rung5_full": ("configs/rung5_16384core_wafer.json", _folded_fft(16384, 8, 32)),
    "zoo_smoke": ("configs/zoo_smoke_16core_torus_moesi.json",
                  _folded_fft(16, 2, 16, ins_per_mem=4)),
    "ipu_full": ("configs/zoo_ipu_1472tile_bsp.json",
                 _folded("barrier_phases", n_cores=1472, n_phases=32,
                         work_per_phase=32, ins_per_mem=2)),
    "headline_moesi": ({**HEADLINE, "coherence": "moesi"}, _folded_fft(1024, 4, 256)),
}


@pytest.mark.parametrize("name", FULL_WIDTH)
def test_full_width_fixture_names_its_machine_and_trace(name):
    """Each full-width fixture records the machine (a shipped config file
    by path, unchanged) and the trace spec that FULL_WIDTH_SPECS gives,
    chunk_steps 512, and a digest of every field `run_digest` makes."""
    with open(os.path.join(PKG, "fixtures", f"{name}.json")) as f:
        fx = json.load(f)
    machine, trace = FULL_WIDTH_SPECS[name]
    assert fx["config"] == machine and fx["trace"] == trace
    assert fx["chunk_steps"] == 512
    if isinstance(machine, str):
        with open(os.path.join(REPO, machine)) as f:
            text = f.read()
        cfg = TCfg.from_json(text)
        assert cfg.to_json() == JCfg.from_json(text).to_json()
    else:
        cfg = TCfg.from_dict(machine)
    assert trace["args"]["n_cores"] == cfg.n_cores
    assert trace["generator"] in t_synth.GENERATORS
    assert set(fx["digest"]) == {
        "steps", "instructions", "max_core_cycles", "cycles_sha256",
        "counters_sha256", "counter_sums", "link_free_sha256",
        "dram_free_sha256",
    }
    assert fx["digest"]["steps"] % fx["chunk_steps"] == 0
    assert fx["digest"]["instructions"] == fx["digest"]["counter_sums"]["instructions"]


def write_fixtures(names=()):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from primesim_tpu.sim.engine import Engine as JEngine

    if names:
        _write_full_width(names)
        return
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
    _write_full_width(FULL_WIDTH)


def _write_full_width(names):
    import time

    for name in names:
        machine, trace = FULL_WIDTH_SPECS[name]
        path = os.path.join(PKG, "fixtures", f"{name}.json")
        with open(path, "w") as f:
            json.dump({"config": machine, "trace": trace, "chunk_steps": 512,
                       "digest": None}, f)
        t0 = time.perf_counter()
        fx, eng = _full_width(name)
        fx["digest"] = digest_of_jax_engine(eng)
        with open(path, "w") as f:
            json.dump(fx, f, indent=1)
            f.write("\n")
        print(f"wrote {path}: {eng.steps_run} steps, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--write-fixture"]:
    write_fixtures(sys.argv[2:])
