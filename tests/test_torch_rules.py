"""The port's ground rules: it imports no JAX and nothing of the JAX
package, it refuses to run quietly on the CPU, it names what it does not
support, its traces and reports are the JAX package's own, and its
committed reference fixtures still match the JAX engine.

The fixtures are the rung-1 run in full (`rung1_fft_small.json`) and
digests (`stats/digest.py`) of ten full-width runs that chip_smoke.py
holds the card to: the 1024-core headline machine (`headline.json`) and
the shipped rung-3 machine (`rung3_headline.json`), both on the folded
headline trace, and the shipped rung-4 (4096 cores, chunked full map)
and rung-5 (16384 cores, coarse sharer vector) machines at full geometry
on folded fft_like traces of their own widths (`rung4_full.json`,
`rung5_full.json`); the machine zoo's shipped 16-core torus/MOESI/stride
machine (`zoo_smoke.json`) and 1472-tile IPU profile (`ipu_full.json`,
a bulk-synchronous barrier trace), and the headline machine under MOESI
(`headline_moesi.json`), the headline machine under a fault schedule
(`headline_faults.json`), the shipped rung-3 machine on four 256-core
programs multiplexed into its 1024 cores (`multiprog_rung3.json`: an FFT,
barriers, locks, a reader-writer) and the shipped rung-2 machine
(`rung2_full.json`); and two fleets, eight elements of the headline
machine and four of rung 3, each element's digest under its own timing
overrides (`fleet_headline.json`, `fleet_rung3.json`); and two streamed
runs, the headline through 256-event windows and rung 5 through 128-event
windows, each a JAX `StreamEngine` digest with its exact step count and
its window count (`stream_headline.json`, `stream_rung5.json`); two
attestation chains, the headline at chunks of 512 and the faulted
headline at chunks of 256, each with its head after every chunk
(`attest_headline.json`, `attest_faults.json`); the served jobs' JAX
solo runs with their chains, four of fleet_headline's elements and four
small jobs on the shipped rung-2 machine (`serve_headline.json`,
`serve_rung2.json`); and digests at a cut depth for the card phases that
run shallower than the whole run (`fleet_rung3_cut.json` at step 1024,
`multiprog_rung3_cut.json` at step 1536, `fleet_fork_cut.json` 512
steps past its fork; `headline_cut.json`,
`rung3_headline_cut.json`, at step 64 in chunks of 64, where the capture
phase's CPU repeat stops); and the calibrate and chaos paths' JAX
results: two `fit` reports (`calib_rung1.json`, rung 1 cut to 6 rounds;
`calib_zoo_selftest.json`), a 1472-tile `simulate_matrix`
(`calib_ipu_matrix.json`), a rung-2 campaign (`chaos_rung2.json`) and
one trial of each opt-in fault class (`chaos_classes.json`). The small
ones are re-derived from JAX in tier 1, the full-width ones and the
rung-1 fit by slow tests.
Regenerate them (after a deliberate change of
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
import re
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
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.trace import synth as t_synth
from primesim_tpu_torch.trace.format import fold_ins as t_fold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(primesim_tpu_torch.__file__)
FIXTURE = os.path.join(PKG, "fixtures", "rung1_fft_small.json")
FULL_WIDTH = ("headline", "rung3_headline", "rung4_full", "rung5_full",
              "zoo_smoke", "ipu_full", "headline_moesi", "headline_faults",
              "multiprog_rung3", "rung2_full")
SMALL_WIDTH = ("zoo_smoke", "rung2_full")  # JAX runs quick enough for tier 1
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


def test_the_rules_cover_every_module_of_the_port():
    """The import and AST rules walk the whole package: the telemetry,
    checkpoint, XML, fleet, supervision, disk-governance, ingest,
    attestation, chaos, serving, pool, replication and offline
    verification modules are among the modules they check (the serving
    daemon's Prometheus renderer `obs/prom.py`, the dispatcher, the
    pipelined ingest, the replicated journal, fsck, the audit, the crash
    campaigns, the knob calibration, the kernel build cache and the tile
    mesh's `parallel/` included), and the JAX package's unported module
    (the linter) is not in the port."""
    rel = {os.path.relpath(p, PKG) for p in _modules()}
    for m in ("obs/__init__.py", "obs/metrics.py", "obs/recorder.py", "obs/trace.py",
              "obs/prom.py", "sim/checkpoint.py", "config/xml_compat.py", "cli.py",
              "sim/fleet.py", "sim/prefix.py", "sim/supervisor.py", "util/__init__.py",
              "util/backoff.py", "util/diskpressure.py", "ingest/__init__.py",
              "ingest/stream.py", "ingest/ring.py", "ingest/capture.py",
              "attest/__init__.py", "attest/errors.py", "attest/chain.py",
              "chaos/__init__.py", "chaos/plan.py", "chaos/sites.py",
              "serve/__init__.py", "serve/jobs.py", "serve/protocol.py", "serve/quota.py",
              "serve/journal.py", "serve/client.py", "serve/scheduler.py",
              "serve/server.py", "serve/dispatch.py", "pool/__init__.py", "pool/units.py",
              "pool/coordinator.py", "pool/worker.py", "pool/campaign.py",
              "ingest/pipeline.py", "serve/replicate.py", "analysis/__init__.py",
              "analysis/errors.py", "analysis/fsck.py", "attest/audit.py",
              "chaos/campaign.py", "calib/__init__.py", "calib/table.py",
              "calib/fit.py", "sim/exec_cache.py", "parallel/__init__.py",
              "parallel/sharding.py", "parallel/distributed.py"):
        assert m in rel, m
    for m in ("analysis/lint.py",):
        assert m not in rel, m


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


def test_parallel_imports_torch_distributed_and_nothing_of_jax():
    """`parallel/` (the tile mesh and its process group) imports the
    standard library, torch (`torch.distributed` among it) and the port's
    own modules: never jax, jaxlib or the JAX package."""
    allowed = {"__future__", "math", "os", "re", "typing", "torch"}
    seen = set()
    for name in ("__init__.py", "sharding.py", "distributed.py"):
        path = os.path.join(PKG, "parallel", name)
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                seen.add(m)
                assert m.split(".")[0] in allowed, (name, m)
    assert "torch.distributed" in seen


def test_no_path_refuses_a_mesh_as_not_ported():
    """Every path of the port takes a tile mesh (`--devices`/`devices`):
    no module of the port, and not chip_smoke.py, defines, raises or
    names the refusal class the port carried while paths were still
    unported (`MultiDeviceNotPorted`)."""
    gone = "MultiDeviceNotPorted"
    for path in _modules() + [os.path.join(REPO, "chip_smoke.py")]:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = {getattr(node, k, None) for k in ("id", "attr", "name")}
            if isinstance(node, ast.alias):
                names |= {node.name, node.asname}
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                names.add(node.value if gone in node.value else None)
            assert not any(n and gone in n for n in names), (path, node.lineno)


def _is_cpu_test(test) -> bool:
    """`<x>.type == "cpu"`: the wrappers' test for a CPU tensor."""
    return (isinstance(test, ast.Compare) and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type" and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


def test_no_path_hands_a_card_tensor_to_a_plain_version(tmp_path):
    """A plain torch version of a kernel (`*_plain`) is called only in
    `kernels/`, and there only under a wrapper's `dev.type == "cpu"`
    branch or from inside another plain version: no module of the port,
    the kernel build cache and the overlapped dispatch included, can
    hand it a tensor on the card. And on a device that is neither, with
    the build cache on, a wrapper raises rather than falling back."""
    calls = 0
    for path in _modules():
        tree = ast.parse(open(path).read(), path)
        parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id.endswith("_plain")):
                continue
            calls += 1
            assert os.path.relpath(path, PKG).startswith("kernels" + os.sep), (path, node.lineno)
            up, ok = node, False
            while up in parents and not ok:
                up = parents[up]
                ok = (isinstance(up, ast.If) and _is_cpu_test(up.test)) or (
                    isinstance(up, ast.FunctionDef) and up.name.endswith("_plain"))
                if isinstance(up, ast.FunctionDef):
                    break
            assert ok, (path, node.lineno)
    assert calls >= 4
    from primesim_tpu_torch.kernels import reductions
    from primesim_tpu_torch.sim import exec_cache

    exec_cache.configure(True, root=str(tmp_path))
    try:
        cfg = TCfg.from_json(small_test_config(8, n_banks=4).to_json())
        t = torch.zeros((8, 1), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            reductions.sharer_reductions(cfg, t, t, t[:, 0], t[:, 0], t[:, 0].bool(),
                                         t[:, 0].bool(), t[:, 0], 1, 1)
    finally:
        exec_cache.configure(False)


# a module path of the JAX package, or a command that runs it
_JAX_PACKAGE_NAME = re.compile(r"primesim_tpu\.|-m primesim_tpu(?!_torch)|^primesim_tpu$")


def test_no_string_of_the_port_names_the_jax_package():
    """No string the port's code holds (docstrings aside) names a module
    of the JAX package or runs it (`-m primesim_tpu`): the processes the
    pool, the daemon and the pipelined run spawn are `python -m
    primesim_tpu_torch` ones."""
    for path in _modules():
        tree = ast.parse(open(path).read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not _JAX_PACKAGE_NAME.search(node.value), (path, node.lineno, node.value)
    for bad in ("primesim_tpu.cli", "-m primesim_tpu worker", "primesim_tpu"):
        assert _JAX_PACKAGE_NAME.search(bad)
    for good in ("primesim_tpu_torch", "-m primesim_tpu_torch worker", "primesim_tpu_torch.pool"):
        assert not _JAX_PACKAGE_NAME.search(good)


# a child that fails loudly the moment anything initialises CUDA or asks
# for a card, then runs the port's CLI with the given arguments
_NO_CUDA_CHILD = (
    "import sys, torch\n"
    "def touched(*a, **k):\n"
    "    raise SystemExit('CUDA touched')\n"
    "for name in ('_lazy_init', 'init', 'is_available', 'device_count',\n"
    "             'current_device', 'set_device', 'get_device_name'):\n"
    "    setattr(torch.cuda, name, touched)\n"
    "from primesim_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "assert not torch.cuda.is_initialized()\n"
    "sys.exit(rc)\n"
)


def test_replica_and_fsck_processes_never_initialise_cuda(tmp_path):
    """A `replica` process (fed a replicated journal, then stopped with
    SIGTERM) and an `fsck`/`fsck --compare` process touch no CUDA call at
    all: they run with every device entry point of torch.cuda replaced by
    one that exits the process."""
    import signal

    from primesim_tpu_torch.serve.journal import JobJournal
    from primesim_tpu_torch.serve.replicate import ReplicationSink

    env = dict(os.environ, PYTHONPATH=REPO)
    rdir = str(tmp_path / "replica")
    proc = subprocess.Popen([sys.executable, "-c", _NO_CUDA_CHILD, "replica", "--dir", rdir,
                             "--tcp", "127.0.0.1:0"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert "replica: listening on" in line, line + proc.stderr.read()
        target = line.split("listening on ", 1)[1].split(" ", 1)[0]
        pdir = str(tmp_path / "primary")
        j = JobJournal(pdir, segment_records=2)
        sink = ReplicationSink(j, [target], node="A")
        j.sink = sink
        sink.begin_epoch()
        for i in range(5):
            j.append({"t": "note", "msg": f"n{i}"})
        assert sink.quorum_ok()
        sink.close()
        j.close()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    for args in (["fsck", str(tmp_path)], ["fsck", "--compare", pdir, rdir]):
        r = subprocess.run([sys.executable, "-c", _NO_CUDA_CHILD, *args], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 corrupt" in r.stdout


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
    "kw",
    [dict(faults_enabled=True, max_fault_events=2, fault_seed=3,
          fault_events=((0, 2, 0, 0), (3, 1, 2, 0)), fault_flip_l1=0.5,
          fault_flip_llc=0.5, fault_due_rate=0.5)],
    ids=["faults_enabled"],
)
def test_fault_fields_are_accepted(kw):
    """An armed fault model (a failed link, a fail-stop, ECC draws) runs in
    the port, to the JAX engine's cycles and counters."""
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
    assert te.counters["core_failstops"].sum() == 1 and te.counters["ecc_corrected"].any()


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


def _faults_section(path):
    with open(path) as f:
        text = f.read()
    return text[text.index("FAULTS"):].split("\n\n")[0]


def test_cli_fault_schedule_matches_primetpu_run(tmp_path, capsys):
    """`run --fault-schedule F --fault-seed 7`: the port's summary line and
    its FAULTS report section equal `primetpu run`'s on the same inputs,
    field for field (the engine's name, the host's wall time and the MIPS
    made from it excepted)."""
    from primesim_tpu.cli import main as jax_main

    sched = tmp_path / "faults.json"
    sched.write_text(json.dumps({
        "events": [{"step": 5, "kind": "core_failstop", "core": 3},
                   {"step": 2, "kind": "link_fail", "link": 4},
                   {"step": 2, "kind": "link_degrade", "link": 9, "extra": 4}],
        "flip_l1": 0.02, "flip_llc": 0.02, "due_rate": 0.5, "due_failstop": True,
    }))
    spec = "fft_like:n_phases=1,points_per_core=8,seed=3"
    args = ["run", RUNG1, "--synth", spec, "--fold", "--fault-schedule", str(sched),
            "--fault-seed", "7"]
    j_rep, t_rep = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jax_main(args + ["--engine", "jax", "--report", str(j_rep)]) == 0
    j_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    r = subprocess.run(
        [sys.executable, "-m", "primesim_tpu_torch", *args, "--device", "cpu",
         "--report", str(t_rep)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    t_sum = json.loads(r.stdout.strip().splitlines()[-1])
    for k in ("metric", "unit"):
        assert t_sum[k] == j_sum[k]
    jd, td = j_sum["detail"], t_sum["detail"]
    for k in ("n_cores", "instructions", "max_core_cycles", "noc_msgs"):
        assert td[k] == jd[k], k
    assert _faults_section(t_rep) == _faults_section(j_rep)
    assert "dead cores" in _faults_section(t_rep)
    assert _report_body(t_rep) == _report_body(j_rep)


def test_cli_fault_errors_match_primetpu_run(tmp_path, capsys):
    """A bad schedule exits 2 with primetpu's one JSON error line; a bare
    --fault-seed on an unarmed config is refused as primetpu refuses it."""
    from primesim_tpu.cli import main as jax_main
    from primesim_tpu_torch.cli import main

    sched = tmp_path / "bad.json"
    sched.write_text(json.dumps({"events": [{"step": 1, "kind": "meteor"}]}))
    args = ["run", RUNG1, "--synth", "stream:n_mem_ops=4", "--fault-schedule", str(sched)]
    assert jax_main(args) == 2
    j_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert main(args + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == j_err
    assert json.loads(j_err)["error"]["type"] == "FaultConfigError"
    bare = ["run", RUNG1, "--synth", "stream:n_mem_ops=4", "--fault-seed", "7"]
    with pytest.raises(SystemExit) as je:
        jax_main(bare)
    with pytest.raises(SystemExit) as te:
        main(bare + ["--device", "cpu"])
    assert str(te.value) == str(je.value) and "fault-seed" in str(te.value)


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
    cfg = JCfg.from_dict(spec)
    tr = jax_trace(fx["trace"], cfg.line_bits)
    eng = JEngine(cfg, tr, chunk_steps=fx["chunk_steps"])
    eng.run()
    return fx, eng


def jax_trace(spec, line_bits):
    """The JAX package's trace of a fixture's trace spec: one generator's,
    or the programs of {"multiplex": [spec, ...]} multiplexed into one
    machine; folded after that when the spec says so."""
    from primesim_tpu.trace.format import multiplex

    if "multiplex" in spec:
        tr = multiplex([j_synth.GENERATORS[p["generator"]](**p["args"])
                        for p in spec["multiplex"]], line_bits=line_bits)
    else:
        tr = j_synth.GENERATORS[spec["generator"]](**spec["args"])
    return j_fold(tr) if spec.get("fold") else tr


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
# card path with barriers); the headline machine under MOESI; the headline
# machine under a fault schedule (two failed links at tile 528, two
# degraded links, three scheduled fail-stops, L1 and LLC flips with DUEs
# that kill their cores, dead owners written back) and fault seed 7
HEADLINE_FAULTS = {
    **HEADLINE,
    "faults_enabled": True, "max_fault_events": 8, "fault_seed": 7,
    "fault_events": [[32, 2, 2112, 0], [32, 2, 2114, 0], [32, 3, 2048, 6],
                     [32, 3, 0, 6], [256, 1, 13, 0], [640, 1, 517, 0],
                     [1024, 1, 1000, 0]],
    "fault_flip_l1": 1e-4, "fault_flip_llc": 1e-4, "fault_due_rate": 0.05,
    "fault_due_failstop": True, "fault_dead_policy": "writeback",
}
# four 256-core programs multiplexed into rung 3's 1024 cores (the
# reference's multiprogrammed mode): an FFT, a barrier program, a lock
# program and a reader-writer program; their locks and barriers go
# through the router (router_cascade's barrier-arrival leg)
MULTIPROG = {
    "multiplex": [
        {"generator": "fft_like", "args": {
            "n_cores": 256, "n_phases": 4, "points_per_core": 256,
            "ins_per_mem": 8, "seed": 42}},
        {"generator": "barrier_phases", "args": {
            "n_cores": 256, "n_phases": 4, "work_per_phase": 16, "seed": 42}},
        {"generator": "lock_contention", "args": {
            "n_cores": 256, "n_critical": 4, "n_locks": 8, "seed": 42}},
        {"generator": "readers_writer", "args": {
            "n_cores": 256, "n_rounds": 16, "seed": 42}},
    ],
    "fold": True,
}
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
    "headline_faults": (HEADLINE_FAULTS, _folded_fft(1024, 4, 256)),
    "multiprog_rung3": ("configs/rung3_1024core_o3.json", MULTIPROG),
    "rung2_full": ("configs/rung2_256core_parsec.json",
                   _folded("fft_like", n_cores=256, n_phases=4, points_per_core=128)),
}


# the two fleet fixtures: bench.py's headline machine, eight elements
# (seven on the headline trace, each with its own timing overrides so
# that every knob a kernel reads differs between some two elements, and
# one on a two-phase trace of another seed that finishes chunks early and
# freezes), and the shipped rung-3 machine, four elements on the headline
# trace. Each element's digest is that of a solo JAX Engine run of
# `apply_overrides(cfg, overrides)` at chunk_steps 512, which
# tests/test_fleet.py shows equals the JAX FleetEngine's element: a JAX
# fleet of eight 1024-core machines would hold some 8 x 7 GB of host
# memory at once.
FLEET = ("fleet_headline", "fleet_rung3")
_HEADLINE_FFT = _folded_fft(1024, 4, 256)
FLEET_SPECS = {
    "fleet_headline": (HEADLINE, [
        *((_HEADLINE_FFT, ov) for ov in (
            {}, {"llc_lat": 20}, {"link_lat": 2, "router_lat": 2},
            {"link_lat": 3, "llc_lat": 14}, {"dram_lat": 200, "l1_lat": 3},
            {"quantum": 500}, {"cpi": 2})),
        ({"generator": "fft_like", "args": {
            "n_cores": 1024, "n_phases": 2, "points_per_core": 256,
            "ins_per_mem": 8, "seed": 43}, "fold": True}, {"link_lat": 2}),
    ]),
    "fleet_rung3": ("configs/rung3_1024core_o3.json", [
        (_HEADLINE_FFT, ov) for ov in (
            {}, {"link_lat": 2, "router_lat": 2},
            {"contention_lat": 3, "dram_service": 20},
            {"quantum": 500, "llc_lat": 20})
    ]),
}
FLEET_SOLO = {"fleet_headline": "headline", "fleet_rung3": "rung3_headline"}
# the prefix-fork fleet: the headline machine under a schedule with ECC
# rates 0 (core 1023, one of the 519 cores still running at step 1024,
# fail-stops there; link 2112 fails at 1280), four elements on the
# headline trace. Three differ only in their fault seed, which rates 0
# leave unreachable, so they share the 1024-step prefix before the
# schedule's first event; the fourth also overrides dram_lat and is not
# forked.
FLEET_FORK = {
    **HEADLINE, "faults_enabled": True, "max_fault_events": 2,
    "fault_events": [[1024, 1, 1023, 0], [1280, 2, 2112, 0]],
    "fault_dead_policy": "writeback",
}
FORK_SPECS = {"fleet_fork": (FLEET_FORK, [
    (_HEADLINE_FFT, ov) for ov in (
        {"fault_seed": 100}, {"fault_seed": 101}, {"fault_seed": 102},
        {"fault_seed": 103, "dram_lat": 200})
])}
ALL_FLEET_SPECS = {**FLEET_SPECS, **FORK_SPECS}


def _fleet_fixture(name):
    with open(os.path.join(PKG, "fixtures", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", FLEET)
def test_fleet_fixture_names_its_machine_traces_and_overrides(name):
    """Each fleet fixture records the machine, every element's trace spec
    and overrides as FLEET_SPECS gives them, chunk_steps 512 and a
    digest per element; element 0 is the solo full-width fixture's run,
    and the elements differ."""
    fx = _fleet_fixture(name)
    machine, elements = FLEET_SPECS[name]
    assert fx["config"] == machine and fx["chunk_steps"] == 512
    assert [(e["trace"], e["overrides"]) for e in fx["elements"]] == [
        (t, ov) for t, ov in elements]
    with open(os.path.join(PKG, "fixtures", f"{FLEET_SOLO[name]}.json")) as f:
        solo = json.load(f)
    assert solo["config"] == machine and solo["trace"] == elements[0][0]
    assert fx["elements"][0]["digest"] == solo["digest"]
    shas = {e["digest"]["cycles_sha256"] for e in fx["elements"]}
    assert len(shas) == len(elements)
    for e in fx["elements"]:
        assert e["digest"]["steps"] % 512 == 0


def test_fleet_fork_fixture_names_its_machine_traces_and_overrides():
    """The prefix-fork fleet's fixture records FORK_SPECS' machine, traces
    and overrides at chunk_steps 512. Its premises hold in the JAX runs:
    the three seed-only elements end alike (rates 0 leave the seed
    unreachable), the dram_lat element differs, core 1023's scheduled
    kill landed and the failed link rerouted traffic in every element."""
    fx = _fleet_fixture("fleet_fork")
    machine, elements = FORK_SPECS["fleet_fork"]
    assert fx["config"] == machine and fx["chunk_steps"] == 512
    assert [(e["trace"], e["overrides"]) for e in fx["elements"]] == [
        (t, ov) for t, ov in elements]
    d = [e["digest"] for e in fx["elements"]]
    assert d[0] == d[1] == d[2] != d[3]
    for e in d:
        assert e["steps"] % 512 == 0 and e["steps"] > 1280
        assert e["counter_sums"]["core_failstops"] == 1
        assert e["counter_sums"]["noc_reroutes"] > 0


def _fleet_element_digest(name, i):
    """The JAX package's digest of fleet element i: a solo JAX Engine on
    the element's effective config."""
    from primesim_tpu.sim.engine import Engine as JEngine
    from primesim_tpu.sim.fleet import apply_overrides

    machine, elements = ALL_FLEET_SPECS[name]
    if isinstance(machine, str):
        with open(os.path.join(REPO, machine)) as f:
            machine = json.load(f)
    cfg = JCfg.from_dict(machine)
    spec, ov = elements[i]
    eng = JEngine(apply_overrides(cfg, ov), jax_trace(spec, cfg.line_bits), chunk_steps=512)
    eng.run()
    return digest_of_jax_engine(eng)


@pytest.mark.slow  # eight and four 1024-core JAX runs
@pytest.mark.parametrize("name", ALL_FLEET_SPECS)
def test_fleet_digests_match_the_jax_engine(name):
    fx = _fleet_fixture(name)
    for i, e in enumerate(fx["elements"]):
        assert _fleet_element_digest(name, i) == e["digest"], i


def _write_fleet(name, workers=4):
    """Write a fleet fixture, its elements' JAX runs in `workers`
    processes at once."""
    import multiprocessing as mp
    import time

    t0 = time.perf_counter()
    machine, elements = ALL_FLEET_SPECS[name]
    with mp.get_context("spawn").Pool(workers) as pool:
        digests = pool.starmap(_fleet_element_digest, [(name, i) for i in range(len(elements))])
    fx = {"config": machine, "chunk_steps": 512,
          "made_with": "solo JAX Engine runs of apply_overrides(config, overrides), "
                       "one per element (tests/test_torch_rules.py::ALL_FLEET_SPECS)",
          "elements": [{"trace": t, "overrides": ov, "digest": d}
                       for (t, ov), d in zip(elements, digests)]}
    path = os.path.join(PKG, "fixtures", f"{name}.json")
    with open(path, "w") as f:
        json.dump(fx, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {[d['steps'] for d in digests]} steps, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
    programs = trace.get("multiplex", [trace])
    assert sum(p["args"]["n_cores"] for p in programs) == cfg.n_cores
    assert all(p["generator"] in t_synth.GENERATORS for p in programs)
    assert set(fx["digest"]) == {
        "steps", "instructions", "max_core_cycles", "cycles_sha256",
        "counters_sha256", "counter_sums", "link_free_sha256",
        "dram_free_sha256",
    }
    assert fx["digest"]["steps"] % fx["chunk_steps"] == 0
    assert fx["digest"]["instructions"] == fx["digest"]["counter_sums"]["instructions"]


# the streamed fixtures: a full-width fixture's machine and trace run by
# the JAX package's StreamEngine through `window_events`-deep windows. The
# digest adds the window count; its steps are the exact step count (the
# preloaded digest's are rounded up to whole chunks), and every other
# field equals the full-width fixture's: the headline and rung 5 run no
# router and no DRAM queue, so their link and controller clocks stay 0
# whatever the rebase cadence
STREAM_SPECS = {"stream_headline": ("headline", 256), "stream_rung5": ("rung5_full", 128)}


def _stream_fixture(name):
    with open(os.path.join(PKG, "fixtures", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", STREAM_SPECS)
def test_stream_fixture_names_its_machine_trace_and_window(name):
    """Each stream fixture records its full-width fixture's machine and
    trace and its window size; its digest equals that fixture's but for
    the steps, which are exact (no more than the chunk-rounded count, and
    more than the chunk before it), and it counts at least as many
    windows as the longest core's events need."""
    fx = _stream_fixture(name)
    base, window = STREAM_SPECS[name]
    with open(os.path.join(PKG, "fixtures", f"{base}.json")) as f:
        full = json.load(f)
    assert (fx["config"], fx["trace"], fx["window_events"]) == (
        full["config"], full["trace"], window)
    d, fd = dict(fx["digest"]), full["digest"]
    windows, steps = d.pop("windows"), d.pop("steps")
    assert d == {k: v for k, v in fd.items() if k != "steps"}
    assert fd["steps"] - full["chunk_steps"] < steps <= fd["steps"]
    trace = FULL_WIDTH_SPECS[base][1]
    tr = t_fold(t_synth.GENERATORS[trace["generator"]](**trace["args"]))
    assert windows >= -(-int(tr.lengths.max() - 1) // window)


def stream_digest_of_jax(name) -> dict:
    """The JAX package's StreamEngine run of a stream fixture: its digest
    with the window count."""
    from primesim_tpu.ingest.stream import StreamEngine as JStream

    fx = _stream_fixture(name)
    spec = fx["config"]
    if isinstance(spec, str):
        with open(os.path.join(REPO, spec)) as f:
            spec = json.load(f)
    cfg = JCfg.from_dict(spec)
    eng = JStream(cfg, jax_trace(fx["trace"], cfg.line_bits), window_events=fx["window_events"])
    windows, budget = 0, eng._default_budget()
    while True:
        k, finished = eng._advance_window(budget)
        budget -= k
        windows += 1
        if finished:
            break
    return {**digest_of_jax_engine(eng), "windows": windows}


@pytest.mark.slow  # a 1024- and a 16384-core JAX stream run
@pytest.mark.parametrize("name", STREAM_SPECS)
def test_stream_digests_match_the_jax_stream_engine(name):
    assert stream_digest_of_jax(name) == _stream_fixture(name)["digest"]


def _write_stream(name):
    import time

    t0 = time.perf_counter()
    base, window = STREAM_SPECS[name]
    with open(os.path.join(PKG, "fixtures", f"{base}.json")) as f:
        full = json.load(f)
    path = os.path.join(PKG, "fixtures", f"{name}.json")
    fx = {"config": full["config"], "trace": full["trace"], "window_events": window,
          "made_with": "the JAX package's StreamEngine run window by window "
                       "(tests/test_torch_rules.py::stream_digest_of_jax)",
          "digest": None}
    with open(path, "w") as f:
        json.dump(fx, f)
    fx["digest"] = stream_digest_of_jax(name)
    with open(path, "w") as f:
        json.dump(fx, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {fx['digest']['steps']} steps, {fx['digest']['windows']} "
          f"windows, {time.perf_counter() - t0:.1f} s", flush=True)


# ---- attestation, serving and cut-depth fixtures ---------------------------
#
# attest_headline / attest_faults: a full-width fixture's machine and trace
# run by the JAX Engine's chunked loop with a SoloAttest chain at
# `chunk_steps`, recording the chain head after every chunk (a mismatch on
# the card names the first chunk whose committed state differs), the final
# payload and the run's digest. serve_headline: four of fleet_headline's
# elements as serving jobs, each a solo JAX run at the fleet fixture's
# cadence with its chain (element 0's is attest_headline's last head).
# serve_rung2: four small jobs on the shipped rung-2 machine, each a solo
# JAX run's served-result digest and chain at the daemon's cadence. The
# cut-depth fixtures: a fixture's runs stopped after `steps` steps
# (`run_steps`), for card phases that run shallower than the whole run.
ATTEST_SPECS = {"attest_headline": ("headline", 512), "attest_faults": ("headline_faults", 256)}
SERVE_HEADLINE_ELEMENTS = (0, 1, 2, 7)
SERVE_RUNG2 = {
    "config": "configs/rung2_256core_parsec.json",
    "chunk_steps": 64,
    "jobs": [
        ("fft_like:n_phases=4,points_per_core=96,ins_per_mem=8,seed=%d" % s, ov)
        for s, ov in ((51, {}), (52, {"llc_lat": 20}), (53, {"link_lat": 2}),
                      (54, {"quantum": 500, "dram_lat": 200}))
    ],
}
# name -> (base fixture, steps, chunk_steps): JAX's run_steps rounds up
# to whole chunks, so a cut shallower than 512 steps names its chunk; a
# fleet whose elements stand at different steps at the cut (fleet_fork:
# three forked from a 1024-step prefix, one from step 0) names each
# element's
CUT_SPECS = {"fleet_rung3_cut": ("fleet_rung3", 1024, 512),
             "multiprog_rung3_cut": ("multiprog_rung3", 1536, 512),
             "fleet_fork_cut": ("fleet_fork", (1536, 1536, 1536, 512), 512),
             "headline_cut": ("headline", 64, 64),
             "rung3_headline_cut": ("rung3_headline", 64, 64),
             "sharded_headline_cut": ("headline", 512, 64),
             "sharded_rung3_cut": ("rung3_headline", 256, 64),
             "rung3_headline_cut1024": ("rung3_headline", 1024, 512),
             "ipu_cut": ("ipu_full", 1024, 512)}
ATTEST_FIXTURES = (*ATTEST_SPECS, "serve_headline", "serve_rung2", *CUT_SPECS)


def _jax_cfg(machine):
    if isinstance(machine, str):
        with open(os.path.join(REPO, machine)) as f:
            machine = json.load(f)
    return JCfg.from_dict(machine)


def attested_jax_run(cfg, tr, chunk_steps):
    """A JAX Engine's chunked run with a SoloAttest chain: (the engine,
    the chain head after every chunk)."""
    from primesim_tpu.attest import SoloAttest
    from primesim_tpu.sim.engine import Engine as JEngine

    eng = JEngine(cfg, tr, chunk_steps=chunk_steps)
    eng.attest = SoloAttest(chunk_steps)
    heads, observe = [], eng.attest.observe

    def recorded(e):
        observe(e)
        heads.append(eng.attest.payload()["head"])

    eng.attest.observe = recorded
    eng.run_chunked()
    return eng, heads


def attest_fixture_of_jax(name) -> dict:
    base, chunk = ATTEST_SPECS[name]
    machine, trace = FULL_WIDTH_SPECS[base]
    cfg = _jax_cfg(machine)
    eng, heads = attested_jax_run(cfg, jax_trace(trace, cfg.line_bits), chunk)
    return {"config": machine, "trace": trace, "chunk_steps": chunk,
            "made_with": "the JAX Engine's run_chunked with a SoloAttest chain "
                         "(tests/test_torch_rules.py::attest_fixture_of_jax)",
            "heads": heads, "attest": eng.attest.payload(),
            "digest": digest_of_jax_engine(eng)}


def served_digest(result: dict) -> dict:
    """What a served job's result record is held to: its fixture digest's
    fields but the link and controller clocks (a result does not carry
    them)."""
    from primesim_tpu_torch.stats.digest import run_digest

    d = run_digest(result["steps"], result["core_cycles"],
                   {k: np.asarray(v) for k, v in result["counters"].items()}, [], [])
    return {k: v for k, v in d.items() if k not in ("link_free_sha256", "dram_free_sha256")}


def serve_headline_element(i) -> dict:
    """fleet_headline's element i as a served job: a solo JAX run at the
    fleet fixture's cadence with its chain."""
    from primesim_tpu.sim.fleet import apply_overrides

    machine, elements = FLEET_SPECS["fleet_headline"]
    spec, ov = elements[i]
    cfg = _jax_cfg(machine)
    eng, _ = attested_jax_run(apply_overrides(cfg, ov), jax_trace(spec, cfg.line_bits), 512)
    d = digest_of_jax_engine(eng)
    return {"element": i, "trace": spec, "overrides": ov,
            "digest": {k: v for k, v in d.items()
                       if k not in ("link_free_sha256", "dram_free_sha256")},
            "attest": eng.attest.payload()}


def serve_rung2_job(i) -> dict:
    """SERVE_RUNG2's job i: a solo JAX run of its folded synth spec under
    its overrides, at the daemon's cadence with its chain."""
    from primesim_tpu.serve.scheduler import parse_synth_spec
    from primesim_tpu.sim.fleet import apply_overrides

    spec, ov = SERVE_RUNG2["jobs"][i]
    cfg = _jax_cfg(SERVE_RUNG2["config"])
    eng, _ = attested_jax_run(apply_overrides(cfg, ov),
                              parse_synth_spec(spec, cfg.n_cores, True),
                              SERVE_RUNG2["chunk_steps"])
    d = digest_of_jax_engine(eng)
    return {"synth": spec, "overrides": ov,
            "digest": {k: v for k, v in d.items()
                       if k not in ("link_free_sha256", "dram_free_sha256")},
            "attest": eng.attest.payload()}


def cut_digest_of_jax(name, i=0) -> dict:
    """The digest after CUT_SPECS[name]'s steps (`run_steps`) of its base
    fixture's run: fleet element i's solo run, or the solo run."""
    from primesim_tpu.sim.engine import Engine as JEngine
    from primesim_tpu.sim.fleet import apply_overrides

    base, steps, chunk = CUT_SPECS[name]
    if base in ALL_FLEET_SPECS:
        machine, elements = ALL_FLEET_SPECS[base]
        spec, ov = elements[i]
    else:
        (machine, spec), ov = FULL_WIDTH_SPECS[base], {}
    cfg = _jax_cfg(machine)
    eng = JEngine(apply_overrides(cfg, ov), jax_trace(spec, cfg.line_bits), chunk_steps=chunk)
    eng.run_steps(steps[i] if isinstance(steps, tuple) else steps)
    return digest_of_jax_engine(eng)


def _write_json(name, fx):
    path = os.path.join(PKG, "fixtures", f"{name}.json")
    with open(path, "w") as f:
        json.dump(fx, f, indent=1)
        f.write("\n")
    print(f"wrote {path}", flush=True)


def _write_attest_fixtures(names, workers=6):
    """Write the attestation, serving and cut-depth fixtures, their JAX
    runs in `workers` processes at once."""
    import multiprocessing as mp

    jobs = []
    for n in names:
        if n in ATTEST_SPECS:
            jobs.append((n, attest_fixture_of_jax, (n,)))
        elif n == "serve_headline":
            jobs += [(n, serve_headline_element, (i,)) for i in SERVE_HEADLINE_ELEMENTS]
        elif n == "serve_rung2":
            jobs += [(n, serve_rung2_job, (i,)) for i in range(len(SERVE_RUNG2["jobs"]))]
        elif n in CUT_SPECS:
            base = CUT_SPECS[n][0]
            count = len(ALL_FLEET_SPECS[base][1]) if base in ALL_FLEET_SPECS else 1
            jobs += [(n, cut_digest_of_jax, (n, i)) for i in range(count)]
    with mp.get_context("spawn").Pool(workers) as pool:
        outs = pool.starmap(_call, [(fn, args) for _, fn, args in jobs])
    got: dict = {}
    for (n, _, _), out in zip(jobs, outs):
        got.setdefault(n, []).append(out)
    for n, outs in got.items():
        if n in ATTEST_SPECS:
            _write_json(n, outs[0])
        elif n == "serve_headline":
            _write_json(n, {
                "config": FLEET_SPECS["fleet_headline"][0], "chunk_steps": 512,
                "made_with": "solo JAX runs with a SoloAttest chain of fleet_headline's "
                             "elements (tests/test_torch_rules.py::serve_headline_element)",
                "jobs": outs})
        elif n == "serve_rung2":
            _write_json(n, {
                **{k: SERVE_RUNG2[k] for k in ("config", "chunk_steps")},
                "made_with": "solo JAX runs with a SoloAttest chain "
                             "(tests/test_torch_rules.py::serve_rung2_job)",
                "jobs": outs})
        else:
            base, steps, chunk = CUT_SPECS[n]
            _write_json(n, {"base": base, "steps": list(steps) if isinstance(steps, tuple)
                            else steps,
                            **({"chunk_steps": chunk} if chunk != 512 else {}),
                            "made_with": "JAX Engine.run_steps(steps) of the base fixture's "
                                         "run(s) (tests/test_torch_rules.py::cut_digest_of_jax)",
                            "digests": outs})


def _call(fn, args):
    return fn(*args)


def _attest_fixture(name):
    with open(os.path.join(PKG, "fixtures", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ATTEST_SPECS)
def test_attest_fixture_names_its_run_and_a_head_per_chunk(name):
    """Each attestation fixture records its base full-width fixture's
    machine and trace, its cadence, one head per chunk (the last one the
    payload's) and the base run's digest."""
    fx = _attest_fixture(name)
    base, chunk = ATTEST_SPECS[name]
    with open(os.path.join(PKG, "fixtures", f"{base}.json")) as f:
        full = json.load(f)
    assert (fx["config"], fx["trace"], fx["chunk_steps"]) == (full["config"], full["trace"], chunk)
    assert fx["digest"] == full["digest"]
    assert len(fx["heads"]) == fx["attest"]["chunks"] == -(-full["digest"]["steps"] // chunk)
    assert fx["heads"][-1] == fx["attest"]["head"] and len(set(fx["heads"])) == len(fx["heads"])
    assert (fx["attest"]["start"], fx["attest"]["chunk_steps"]) == (0, chunk)


def test_serve_fixtures_name_their_jobs():
    """serve_headline holds fleet_headline's elements 0, 1, 2 and 7 with
    their digests (element 0's chain is attest_headline's); serve_rung2
    holds SERVE_RUNG2's jobs, each a chain at its cadence covering its
    steps."""
    fx, fleet = _attest_fixture("serve_headline"), _fleet_fixture("fleet_headline")
    assert fx["config"] == fleet["config"] and fx["chunk_steps"] == fleet["chunk_steps"]
    for job, i in zip(fx["jobs"], SERVE_HEADLINE_ELEMENTS):
        e = fleet["elements"][i]
        assert (job["element"], job["trace"], job["overrides"]) == (i, e["trace"], e["overrides"])
        assert job["digest"] == {k: v for k, v in e["digest"].items()
                                 if k not in ("link_free_sha256", "dram_free_sha256")}
    assert fx["jobs"][0]["attest"] == _attest_fixture("attest_headline")["attest"]
    r2 = _attest_fixture("serve_rung2")
    assert (r2["config"], r2["chunk_steps"]) == (SERVE_RUNG2["config"], SERVE_RUNG2["chunk_steps"])
    assert [(j["synth"], j["overrides"]) for j in r2["jobs"]] == [
        (sp, ov) for sp, ov in SERVE_RUNG2["jobs"]]
    for j in (*fx["jobs"], *r2["jobs"]):
        at = j["attest"]
        assert at["chunks"] * at["chunk_steps"] == j["digest"]["steps"]


@pytest.mark.parametrize("name", CUT_SPECS)
def test_cut_fixtures_stop_short_of_their_full_runs(name):
    fx = _attest_fixture(name)
    base, steps, chunk = CUT_SPECS[name]
    assert (fx["base"], fx["steps"], fx.get("chunk_steps", 512)) == (
        base, list(steps) if isinstance(steps, tuple) else steps, chunk)
    full = _attest_fixture(base)
    fulls = ([e["digest"] for e in full["elements"]] if "elements" in full
             else [full["digest"]])
    assert len(fx["digests"]) == len(fulls)
    for i, (cut, whole) in enumerate(zip(fx["digests"], fulls)):
        at = steps[i] if isinstance(steps, tuple) else steps
        assert cut["steps"] == min(at, whole["steps"])
        assert (cut["instructions"] < whole["instructions"]) == (whole["steps"] > at)


def test_serve_rung2_fixture_matches_the_jax_engine():
    """The first rung-2 job re-derived from JAX (a 256-core run: tier 1);
    the full-width attestation fixtures are re-derived by the slow test
    below."""
    assert serve_rung2_job(0) == _attest_fixture("serve_rung2")["jobs"][0]


@pytest.mark.slow  # 1024-core JAX runs
@pytest.mark.parametrize("name", [*ATTEST_SPECS, "serve_headline", "serve_rung2",
                                  *CUT_SPECS])
def test_attest_and_serve_fixtures_match_the_jax_engine(name):
    fx = _attest_fixture(name)
    if name in ATTEST_SPECS:
        assert attest_fixture_of_jax(name) == {**fx}
    elif name == "serve_headline":
        assert [serve_headline_element(i) for i in SERVE_HEADLINE_ELEMENTS] == fx["jobs"]
    elif name == "serve_rung2":
        assert [serve_rung2_job(i) for i in range(len(SERVE_RUNG2["jobs"]))] == fx["jobs"]
    else:
        assert [cut_digest_of_jax(name, i) for i in range(len(fx["digests"]))] == fx["digests"]


# the calibrate and chaos fixtures chip_smoke.py holds the card to: JAX
# `fit` runs of the calibrate verb's two paths (the README's machine with
# the default fit keys; the zoo machine's self-test at ground-truth knobs),
# a JAX `simulate_matrix` of the 1472-tile IPU profile at its own knobs
# (one candidate set: B = 4 entries), a JAX campaign on the shipped rung-2
# machine with every trial's result, and one JAX trial of each opt-in
# fault class at the campaign's default small machine (each seed chosen so
# that an event fires; the capacity-loss plan touches only the disk)
CALIB_TABLE = "configs/calib_ipu_microbench.json"
CALIB_SPECS = {
    # rounds cut from the verb's default 24 (145 dispatches, 308 s on the
    # card) to 10 (61), then to 6, so that the card's fit ends beside
    # phases 3-4 on a slow host too
    "calib_rung1": {"config": "configs/rung1_64core_fft.json", "table": CALIB_TABLE, "fit": None,
                    "truth": None, "rounds": 6, "chunk_steps": 256},
    "calib_zoo_selftest": {"config": "configs/zoo_smoke_16core_torus_moesi.json",
                           "table": CALIB_TABLE, "fit": ["llc_lat", "dram_lat"],
                           "truth": {"llc_lat": 16, "dram_lat": 151}, "rounds": 24,
                           "chunk_steps": 256},
}
CALIB_MATRIX = {"config": "configs/zoo_ipu_1472tile_bsp.json", "table": CALIB_TABLE,
                "knob_sets": [{}], "chunk_steps": 256}
CHAOS_RUNG2 = {"config": "configs/rung2_256core_parsec.json", "trials": 6, "seed0": 900,
               "classes": ["durable", "crashpoint"]}
CHAOS_CLASSES = {"socket": 2, "replication": 1, "silent_corruption": 1, "capacity_loss": 8}
CALIB_CHAOS_FIXTURES = (*CALIB_SPECS, "calib_ipu_matrix", "chaos_rung2", "chaos_classes")


def _jax_calib():
    """The JAX package's calib/fit.py module (its package re-exports a
    function of the same name)."""
    import importlib

    return importlib.import_module("primesim_tpu.calib.fit")


def calib_fixture_of_jax(name) -> dict:
    from primesim_tpu.calib.table import load_table

    F, spec = _jax_calib(), CALIB_SPECS[name]
    with open(os.path.join(REPO, spec["config"])) as f:
        cfg = JCfg.from_json(f.read())
    table = load_table(os.path.join(REPO, spec["table"]))
    if spec["truth"]:
        table = F.synthesize_observed(cfg, table, spec["truth"],
                                      chunk_steps=spec["chunk_steps"])
    res = F.fit(cfg, table, fit_keys=tuple(spec["fit"] or F.FIT_KEYS_DEFAULT),
                max_rounds=spec["rounds"], chunk_steps=spec["chunk_steps"])
    return {**spec, "made_with": "JAX calib.fit.fit on the CPU "
                                 "(tests/test_torch_rules.py::calib_fixture_of_jax)",
            "table_name": table.name, "report": res.report()}


def calib_matrix_of_jax() -> dict:
    from primesim_tpu.calib.table import load_table

    spec = CALIB_MATRIX
    with open(os.path.join(REPO, spec["config"])) as f:
        cfg = JCfg.from_json(f.read())
    values = _jax_calib().simulate_matrix(
        cfg, load_table(os.path.join(REPO, spec["table"])), spec["knob_sets"],
        chunk_steps=spec["chunk_steps"])
    return {**spec, "made_with": "JAX calib.fit.simulate_matrix on the CPU "
                                 "(tests/test_torch_rules.py::calib_matrix_of_jax)",
            "values": values}


def chaos_rung2_of_jax() -> dict:
    from primesim_tpu.chaos import campaign as JC

    spec = CHAOS_RUNG2
    with open(os.path.join(REPO, spec["config"])) as f:
        cfg = JCfg.from_json(f.read())
    trials = []
    report = JC.run_campaign(n_trials=spec["trials"], seed0=spec["seed0"],
                             classes=tuple(spec["classes"]), cfg=cfg,
                             progress=lambda seed, res: trials.append(res.as_dict()))
    return {**spec, "made_with": "JAX chaos.campaign.run_campaign on the CPU "
                                 "(tests/test_torch_rules.py::chaos_rung2_of_jax)",
            "report": report, "trial_results": trials}


def chaos_class_plan(P, JC, cls):
    """The plan `run_campaign(classes=(cls,))` draws for CHAOS_CLASSES'
    seed, made with either package's plan and campaign modules."""
    return P.generate(CHAOS_CLASSES[cls], classes=JC._gen_classes((cls,)),
                      sites=JC._trial_sites((cls,))[0])


def chaos_classes_of_jax() -> dict:
    from primesim_tpu.chaos import campaign as JC
    from primesim_tpu.chaos import plan as P

    golden = JC.golden_run()
    trials = {cls: JC.run_trial(chaos_class_plan(P, JC, cls), golden=golden).as_dict()
              for cls in CHAOS_CLASSES}
    return {"made_with": "JAX chaos.campaign golden_run and run_trial at the campaign's "
                         "default machine (tests/test_torch_rules.py::chaos_classes_of_jax)",
            "golden": [JC._canon(golden[i]) for i in sorted(golden)], "trials": trials}


def calib_chaos_fixture_of_jax(name) -> dict:
    if name in CALIB_SPECS:
        return calib_fixture_of_jax(name)
    return {"calib_ipu_matrix": calib_matrix_of_jax, "chaos_rung2": chaos_rung2_of_jax,
            "chaos_classes": chaos_classes_of_jax}[name]()


def _write_calib_chaos_fixtures(names, workers=4):
    """Write the calibrate and chaos fixtures, their JAX runs in `workers`
    processes at once."""
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(workers) as pool:
        outs = pool.starmap(_call, [(calib_chaos_fixture_of_jax, (n,)) for n in names])
    for n, fx in zip(names, outs):
        _write_json(n, fx)


def test_calib_and_chaos_fixtures_name_their_runs():
    """Each calibrate fixture records its machine, table, fit keys, truth,
    round cap and chunk size, and a report whose batch is 5 candidates per
    table entry; the matrix fixture one value per entry; the campaign
    fixture its spec, a clean report and one result per trial whose fired
    events sum to the report's; the class fixture the default machine's
    three golden results and one clean trial per class, each with an
    event fired, the capacity-loss plan on the disk only."""
    with open(os.path.join(REPO, CALIB_TABLE)) as f:
        n_entries = len(json.load(f)["entries"])
    for name, spec in CALIB_SPECS.items():
        fx = _attest_fixture(name)
        assert {k: fx[k] for k in spec} == spec
        assert fx["report"]["batch"] == 5 * n_entries
        assert len(fx["report"]["residuals"]) == n_entries
        assert fx["report"]["rounds"] <= spec["rounds"]
    assert _attest_fixture("calib_zoo_selftest")["report"]["knobs"] == {"llc_lat": 16,
                                                                       "dram_lat": 151}
    mx = _attest_fixture("calib_ipu_matrix")
    assert {k: mx[k] for k in CALIB_MATRIX} == CALIB_MATRIX
    assert [len(v) for v in mx["values"]] == [n_entries]
    cr = _attest_fixture("chaos_rung2")
    assert {k: cr[k] for k in CHAOS_RUNG2} == CHAOS_RUNG2
    rep, trials = cr["report"], cr["trial_results"]
    assert rep["ok"] and rep["trials"] == CHAOS_RUNG2["trials"] == len(trials)
    assert rep["fired_events"] == sum(len(t["injected"]) for t in trials) > 0
    assert [t["seed"] for t in trials] == list(range(900, 906))
    cc = _attest_fixture("chaos_classes")
    assert len(cc["golden"]) == 3 and set(cc["trials"]) == set(CHAOS_CLASSES)
    for cls, t in cc["trials"].items():
        assert t["ok"] and t["injected"] and t["seed"] == CHAOS_CLASSES[cls]
    assert {e["site"] for e in cc["trials"]["capacity_loss"]["plan"]["events"]} == {
        "disk.preflight"}


@pytest.mark.parametrize("name", ["calib_zoo_selftest", "chaos_rung2", "chaos_classes"])
def test_small_calib_and_chaos_fixtures_match_the_jax_package(name):
    """The small calibrate and chaos fixtures re-derived from JAX in tier 1
    (the rung-1 fit, 37 dispatches, and the 1472-tile matrix by the slow
    test below)."""
    fx = _attest_fixture(name)
    got = calib_chaos_fixture_of_jax(name)
    if name == "chaos_classes":  # which events fire may hang on thread timing
        assert got["golden"] == fx["golden"]
        for cls, t in got["trials"].items():
            assert t["injected"]
            assert {k: t[k] for k in ("ok", "seed", "plan", "restarts")} == {
                k: fx["trials"][cls][k] for k in ("ok", "seed", "plan", "restarts")}
        return
    assert got == fx


@pytest.mark.slow  # ~3.5 min of JAX (rung 1); a 1472-tile fleet of 4
@pytest.mark.parametrize("name", ["calib_rung1", "calib_ipu_matrix"])
def test_large_calib_fixtures_match_the_jax_package(name):
    assert calib_chaos_fixture_of_jax(name) == _attest_fixture(name)


def write_fixtures(names=()):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from primesim_tpu.sim.engine import Engine as JEngine

    if names:
        _write_full_width([n for n in names if n not in ALL_FLEET_SPECS
                           and n not in STREAM_SPECS and n not in ATTEST_FIXTURES
                           and n not in CALIB_CHAOS_FIXTURES])
        for n in names:
            if n in ALL_FLEET_SPECS:
                _write_fleet(n)
            if n in STREAM_SPECS:
                _write_stream(n)
        _write_attest_fixtures([n for n in names if n in ATTEST_FIXTURES])
        _write_calib_chaos_fixtures([n for n in names if n in CALIB_CHAOS_FIXTURES])
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
    for n in ALL_FLEET_SPECS:
        _write_fleet(n)
    for n in STREAM_SPECS:
        _write_stream(n)
    _write_attest_fixtures(ATTEST_FIXTURES)
    _write_calib_chaos_fixtures(CALIB_CHAOS_FIXTURES)


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
