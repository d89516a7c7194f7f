"""The port's kernel build cache (`sim/exec_cache.py`, `--exec-cache on`)
on the CPU, mirroring tests/test_exec_cache.py.

This container has `g++` and `gcc` but no `nvcc` and no card. Two kinds
of entry are exercised with real libraries that really build and load:

- the capture shim's `capture` entry, built with `g++` exactly as on the
  card, in this process and in fresh processes, and preloaded (the
  dynamic loader's dlopen) by a real pthread program it captures;
- the four kernel entries, with `nvcc` replaced by `gcc` building one
  stub library per kernel that exports its `<name>_launch` symbol (the
  cache binds that symbol at load), and `nvcc --version` by a fixed
  line.

The JAX package's cases, mapped:

- test_key_sensitive_to_geometry_statics_and_entry:
  `test_key_sensitive_to_toolchain_sources_and_entry` (the port's key
  has no geometry; its fields are the toolchain's and the sources');
- test_key_invariant_to_traced_timing_knobs:
  `test_key_invariant_to_geometry_and_timing_knobs` (two machines of
  other geometry and knobs share the entries);
- test_key_payload_carries_toolchain_and_formats:
  `test_key_payload_carries_the_toolchain_and_formats`;
- test_solo_bit_exact_and_fresh_process_disk_hit:
  `test_kernel_entries_miss_then_hit` and
  `test_a_fresh_process_hits_the_disk`;
- test_corrupt_entry_degrades_to_recompile and
  test_truncated_and_bad_magic_entries:
  `test_a_damaged_entry_is_rebuilt_and_never_loaded` (each damage, both
  entry kinds) and `test_a_rebuilt_shim_still_captures`;
- test_persist_failure_still_runs: `test_a_failed_persist_still_runs`;
- test_inactive_cache_is_a_tail_call:
  `test_an_inactive_cache_takes_the_build_directory`;
- test_timing_variants_share_one_entry and
  test_fleet_warm_exec_and_bit_exact: `test_warm_exec_loads_the_fleets_
  kernels` (and the key invariance case);
- test_shared_lru_budget_spans_warm_and_exec and test_write_entry_prunes:
  the tests of the same names;
- test_fsck_checks_exec_entries and
  test_fsck_exec_sidecar_key_content_agreement: the `test_fsck_*` cases,
  with the port entry's toolchain fields and what the JAX `fsck` reports
  of a port entry;
- tests/test_degrade.py::test_exec_cache_write_enospc_degrades_to_recompile:
  `test_exec_cache_write_enospc_degrades_to_a_rebuild`;
- a JAX plan naming the chaos site `exec_cache.write` fires in the port:
  `test_a_jax_plan_at_exec_cache_write_fires_in_the_port`;
- test_faulted_run_bit_exact, test_prefix_fork_composes_with_cache and
  test_stream_engine_bit_exact: the port's engines on the CPU launch no
  kernel, so the cache cannot change their results; the CPU runs that
  close the ENOSPC and chaos cases are held to the JAX engine all the
  same, and tests/test_torch_overlap.py carries the overlap halves;
- test_sharded_fleet_cache_bit_exact: not ported, it waits for the
  port's multi-device layer (ROADMAP Queue 1 item 11).

Integer simulator: every tolerance is 0.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from primesim_tpu.analysis.fsck import run_fsck as jax_fsck
from primesim_tpu.chaos import plan as j_plan
from primesim_tpu.config.machine import small_test_config
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.trace import synth
from primesim_tpu_torch.analysis.fsck import run_fsck
from primesim_tpu_torch.attest.chain import toolchain_fingerprint
from primesim_tpu_torch.chaos import plan as t_plan
from primesim_tpu_torch.chaos import sites as t_sites
from primesim_tpu_torch.ingest import capture
from primesim_tpu_torch.kernels import build
from primesim_tpu_torch.sim import checkpoint as t_ck
from primesim_tpu_torch.sim import exec_cache
from primesim_tpu_torch.sim.engine import Engine, kernels_of
from primesim_tpu_torch.sim.fleet import FleetEngine
from primesim_tpu_torch.util import diskpressure as t_dp

from test_torch_engine import assert_engines_equal, port_cfg, port_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVCC_LINE = "Cuda compilation tools, release 12.4, V12.4.131"
STUB = 'int {name}_launch(void) {{ return {rc}; }}\n'
PAYLOAD_FIELDS = {"exec_format", "ckpt_format", "backend", "devices", "entry", "torch",
                  "cuda", "nvcc", "arch", "kernels"}

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="native toolchain unavailable",
)


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """The cache under tmp_path, no cache active, no kernel loaded, disk
    governance unconfigured, no chaos plan: before and after each test."""
    monkeypatch.setenv("PRIMETPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(build, "_libs", {})
    t_dp.configure(None)
    exec_cache.configure(False)
    yield
    exec_cache.configure(False)
    t_dp.configure(None)
    t_sites.deactivate()


@pytest.fixture
def fake_nvcc(monkeypatch):
    """`nvcc` replaced by gcc stubs: one library per kernel exporting its
    launch symbol, a ptxas-like report beside each. Returns the list of
    kernel names each build compiled."""
    builds = []

    def compile_into(out, names):
        t0 = time.perf_counter()
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for k in names:
            (out / f"{k}.c").write_text(STUB.format(name=k, rc=0))
            (out / f"{k}.log").write_text(f"ptxas info    : Used 40 registers, {k}\n")
            procs.append(subprocess.Popen(
                ["gcc", "-shared", "-fPIC", "-o", str(out / f"lib{k}.so"), str(out / f"{k}.c")]))
        assert all(p.wait() == 0 for p in procs)
        builds.append(list(names))
        return time.perf_counter() - t0

    monkeypatch.setattr(build, "compile_into", compile_into)
    monkeypatch.setattr(build, "nvcc_version", lambda: NVCC_LINE)
    return builds


def _entries(root, suffix=".bin"):
    return sorted(n for n in os.listdir(root) if n.endswith(suffix)) if os.path.isdir(root) else []


def _cfg(**kw):
    return small_test_config(8, n_banks=4, quantum=200, **kw)


def _trace(seed=41):
    return synth.fft_like(8, n_phases=2, points_per_core=12, seed=seed)


# ---- the key ---------------------------------------------------------------


def test_key_payload_carries_the_toolchain_and_formats(fake_nvcc):
    for entry in (*build.KERNELS, exec_cache.SHIM):
        p = exec_cache.exec_key_payload(entry)
        assert set(p) == PAYLOAD_FIELDS and p["entry"] == entry
        assert p["exec_format"] == exec_cache._FORMAT and p["ckpt_format"] == t_ck._FORMAT
        assert p["torch"] == torch.__version__
    k = exec_cache.exec_key_payload("commit_step")
    assert (k["backend"], k["arch"], k["nvcc"]) == ("cuda", "sm_90a", NVCC_LINE)
    # "same toolchain" means what the attestation fingerprint says it means
    assert k["kernels"] == build.source_key() == toolchain_fingerprint()["kernels"]
    s = exec_cache.exec_key_payload(exec_cache.SHIM)
    assert s["backend"] == "host" and s["kernels"] == capture.shim_source_key()
    assert s["nvcc"] == capture.compiler_version()


CHANGES = {
    "nvcc": lambda mp: mp.setattr(build, "nvcc_version", lambda: "release 12.8, V12.8.61"),
    "torch": lambda mp: mp.setattr(torch, "__version__", "9.9.9"),
    "cuda": lambda mp: mp.setattr(torch.version, "cuda", "13.0"),
    "sources": lambda mp: mp.setattr(build, "source_key", lambda: "0" * 64),
    "exec_format": lambda mp: mp.setattr(exec_cache, "_FORMAT", 2),
    "devices": lambda mp: mp.setattr(torch.cuda, "device_count", lambda: 4),
}


@pytest.mark.parametrize("change", [*CHANGES, "entry"])
def test_key_sensitive_to_toolchain_sources_and_entry(change, fake_nvcc, monkeypatch):
    base = exec_cache.exec_key(exec_cache.exec_key_payload("probe_classify"))
    if change == "entry":
        other = exec_cache.exec_key_payload("commit_step")
    else:
        CHANGES[change](monkeypatch)
        other = exec_cache.exec_key_payload("probe_classify")
    assert exec_cache.exec_key(other) != base


def _fake_card(fleet):
    """The fleet's kernels are looked up as on a card (the CPU runs its
    plain versions): `warm_exec` loads what a card would launch."""
    fleet.device = torch.device("cuda")
    return fleet


def test_key_invariant_to_geometry_and_timing_knobs(fake_nvcc, tmp_path):
    """No machine enters the key: fleets of other geometry, other timing
    knobs and another NoC share one set of entries; a fresh process view
    of the cache loads them all from disk."""
    from primesim_tpu.config.machine import NocConfig

    cache = exec_cache.configure(True)
    machines = [
        (_cfg(), [{}, {"llc_lat": 30, "quantum": 900}]),
        (small_test_config(16, n_banks=8, quantum=500), [{"dram_lat": 60}]),
        (small_test_config(8, n_banks=4, noc=NocConfig(mesh_x=2, mesh_y=2, contention=True,
                                                      contention_model="router")), [{}]),
    ]
    for cfg, ovs in machines:
        tr = port_trace(synth.fft_like(cfg.n_cores, n_phases=1, points_per_core=4, seed=3))
        fl = _fake_card(FleetEngine(port_cfg(cfg), [tr] * len(ovs), ovs, chunk_steps=16,
                                    device="cpu"))
        assert fl.warm_exec() is True
    # the first machine built three kernels, the router machine one more
    assert fake_nvcc == [list(kernels_of(port_cfg(_cfg()))), ["router_cascade"]]
    assert cache.stats["misses"] == 4 and cache.stats["memo_hits"] == 6
    assert len(_entries(cache.root)) == 4
    build._libs.clear()
    fresh = exec_cache.configure(True)
    build.libraries()
    assert fresh.stats["hits"] == 4 and fresh.stats["misses"] == 0
    assert fresh.stats["compile_wall_s"] == 0.0 and len(fake_nvcc) == 2


# ---- miss, hit, fresh processes --------------------------------------------


def test_kernel_entries_miss_then_hit(fake_nvcc):
    cache = exec_cache.configure(True)
    libs = build.libraries()
    assert set(libs) == set(build.KERNELS) and fake_nvcc == [list(build.KERNELS)]
    assert cache.stats["misses"] == 4 and cache.stats["hits"] == 0
    assert cache.stats["compile_wall_s"] > 0 and not cache.warnings
    bins = _entries(cache.root)
    assert len(bins) == 4
    for b in bins:  # each entry has its key-payload sidecar, which hashes to it
        with open(os.path.join(cache.root, b[:-4] + ".json")) as f:
            meta = json.load(f)
        assert meta["key"] == b[:-4] == exec_cache.exec_key(meta["payload"])
        assert meta["size"] == os.path.getsize(os.path.join(cache.root, b))
    assert "Used 40 registers" in build.ptxas_report("commit_step")
    # a fresh cache is a fresh process: nothing built, every library loaded
    build._libs.clear()
    again = exec_cache.configure(True)
    for k, lib in build.libraries().items():
        assert getattr(lib, f"{k}_launch")() == 0
    assert again.stats["hits"] == 4 and again.stats["misses"] == 0
    assert again.stats["compile_wall_s"] == 0.0 and len(fake_nvcc) == 1
    assert "Used 40 registers" in build.ptxas_report("probe_classify")
    build.libraries()  # loaded already: this process's memo, no disk touch
    assert again.stats["hits"] == 4 and again.stats["memo_hits"] == 4


_CHILD = (
    "import json\n"
    "from primesim_tpu_torch.sim import exec_cache\n"
    "from primesim_tpu_torch.ingest import capture\n"
    "c = exec_cache.configure(True)\n"
    "so = capture.build_shim()\n"
    "print(json.dumps({'so': so, **c.stats}))\n"
)


def test_a_fresh_process_hits_the_disk(tmp_path):
    """Two processes on one cache directory: the first builds the shim
    with g++, the second loads it, and the copy each hands out is its
    own, removed when it exits."""
    env = {**os.environ, "PRIMETPU_CACHE_DIR": str(tmp_path / "shared"),
           "PYTHONPATH": REPO}
    out = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                           cwd=str(tmp_path), env=env, timeout=120)
        assert r.returncode == 0, r.stderr
        out.append(json.loads(r.stdout))
    assert (out[0]["misses"], out[0]["hits"]) == (1, 0) and out[0]["compile_wall_s"] > 0
    assert (out[1]["misses"], out[1]["hits"]) == (0, 1) and out[1]["compile_wall_s"] == 0.0
    assert out[0]["so"] != out[1]["so"] and not any(os.path.exists(o["so"]) for o in out)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".ptpu")]


# ---- damage, failures, an inactive cache -----------------------------------

DAMAGE = {
    "crc": lambda b: b[:20] + bytes([b[20] ^ 0xFF]) + b[21:],
    "truncated": lambda b: b[: len(b) // 2],
    "bad_magic": lambda b: b"NOTEXEC!" + b[8:],
    "short": lambda b: b"PTEX",
    "stale": None,  # another entry's (valid) body under this address
}


def _build_entries(kind):
    """Populate the cache with `kind`'s entries; returns their paths."""
    exec_cache.configure(True)
    if kind == "kernel":
        build.libraries()
    else:
        capture.build_shim()
    return [os.path.join(exec_cache.active().root, b) for b in _entries(exec_cache.active().root)]


@pytest.mark.parametrize("kind", ["kernel", "shim"])
@pytest.mark.parametrize("damage", list(DAMAGE))
def test_a_damaged_entry_is_rebuilt_and_never_loaded(damage, kind, fake_nvcc, monkeypatch):
    """Corrupt, truncated, bad-magic and stale entries: a `load` warning,
    a rebuild that replaces the entry, and no damaged byte ever handed to
    the dynamic loader."""
    paths = _build_entries(kind)
    victim = paths[0]
    with open(victim, "rb") as f:
        blob = f.read()
    if damage == "stale":
        other = paths[1] if kind == "kernel" else None
        if other is None:  # one shim entry: a kernel's body under its address
            build._libs.clear()
            exec_cache.configure(True)
            build.libraries(["commit_step"])
            other = os.path.join(exec_cache.active().root,
                                 exec_cache.active().keys["commit_step"] + ".bin")
        with open(other, "rb") as f:
            bad = f.read()
    else:
        bad = DAMAGE[damage](blob)
    with open(victim, "wb") as f:
        f.write(bad)
    loaded = []
    real = exec_cache.ctypes.CDLL

    def cdll(path, *a, **kw):
        with open(path, "rb") as f:
            head = f.read(4)
        loaded.append(head)
        return real(path, *a, **kw)

    monkeypatch.setattr(exec_cache.ctypes, "CDLL", cdll)
    build._libs.clear()
    cache = exec_cache.configure(True)
    if kind == "kernel":
        libs = build.libraries()
        assert all(getattr(lib, f"{k}_launch")() == 0 for k, lib in libs.items())
        assert loaded and all(h == b"\x7fELF" for h in loaded)
        assert cache.stats["misses"] == 1 and cache.stats["hits"] == 3
    else:
        so = capture.build_shim()
        with open(so, "rb") as f:
            assert f.read(4) == b"\x7fELF"
        assert cache.stats["misses"] == 1 and cache.stats["hits"] == 0
    assert cache.stats["errors"] == 1
    (w,) = cache.warnings
    assert w["stage"] == "load" and w["key"] == os.path.basename(victim)[:-4]
    if damage == "crc":
        assert "CRC" in w["error"]
    with open(victim, "rb") as f:  # the rebuild replaced the entry
        assert exec_cache.read_entry(victim)["key"] == w["key"]


def test_a_rebuilt_shim_still_captures(tmp_path):
    """The shim from the cache, and from a rebuild after its entry was
    corrupted, is what the captured program preloads: a real pthread
    program captures the same structure through either."""
    from primesim_tpu_torch.trace.format import EV_BARRIER, EV_LOCK

    binary = str(tmp_path / "ocean_like")
    subprocess.run(["gcc", "-O2", "-fno-builtin", "-U_FORTIFY_SOURCE", "-o", binary,
                    str(capture.FRONTEND / "examples" / "ocean_like.c"), "-lpthread"],
                   check=True, capture_output=True)
    shapes = []
    for step in ("cold", "warm", "corrupt"):
        cache = exec_cache.configure(True)
        if step == "corrupt":
            (victim,) = _entries(cache.root)
            with open(os.path.join(cache.root, victim), "r+b") as f:
                f.seek(30)
                f.write(b"\x00\x01\x02")
        t = capture.capture_run([binary, "2", "1", "1"], line=64)
        types = t.events[:, :, 0]
        shapes.append((t.n_cores, int((types == EV_LOCK).sum()), int((types == EV_BARRIER).sum())))
        assert (cache.stats["misses"], cache.stats["hits"]) == \
            {"cold": (1, 0), "warm": (0, 1), "corrupt": (1, 0)}[step]
    assert shapes[0] == shapes[1] == shapes[2] and shapes[0][0] == 3


def test_a_failed_persist_still_runs(fake_nvcc, monkeypatch):
    """A library that cannot be persisted still serves this process; the
    next process rebuilds it."""
    def boom(self, key, payload, blob):
        raise OSError("read-only file system")

    monkeypatch.setattr(exec_cache.ExecCache, "_write_entry", boom)
    cache = exec_cache.configure(True)
    libs = build.libraries()
    assert all(getattr(lib, f"{k}_launch")() == 0 for k, lib in libs.items())
    assert [w["stage"] for w in cache.warnings] == ["save"] * 4
    assert cache.stats["misses"] == 4 and not _entries(cache.root)


def test_an_inactive_cache_takes_the_build_directory(monkeypatch, tmp_path):
    """Cache off (the default): the kernels come from `_build/` as they
    always did and the shim builds there; no cache is made or consulted,
    and a fleet's warm-up is a no-op."""
    made = []
    monkeypatch.setattr(exec_cache, "ExecCache", lambda *a, **k: made.append(a))
    out = tmp_path / "build"
    out.mkdir()
    for k in build.KERNELS:
        (out / f"{k}.c").write_text(STUB.format(name=k, rc=7))
        subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(out / f"lib{k}.so"),
                        str(out / f"{k}.c")], check=True)
    monkeypatch.setattr(build, "build", lambda: out)
    assert all(getattr(lib, f"{k}_launch")() == 7 for k, lib in build.libraries().items())
    so = capture.build_shim()
    assert so.startswith(str(capture.BUILD_ROOT)) and so.endswith(
        f"capture-{capture.shim_source_key()[:16]}/libptpu_capture.so")
    fl = _fake_card(FleetEngine(port_cfg(_cfg()), [port_trace(_trace())], device="cpu"))
    assert fl.warm_exec() is False and not made and exec_cache.active() is None


def test_warm_exec_loads_the_fleets_kernels(fake_nvcc):
    """Without a cache, and on the CPU (no kernel launched), the warm-up
    reports False; with one on a card it loads exactly the kernels the
    fleet's mode launches."""
    fl = FleetEngine(port_cfg(_cfg()), [port_trace(_trace())], device="cpu")
    assert fl.warm_exec() is False
    exec_cache.configure(True)
    assert fl.warm_exec() is False  # the CPU launches no kernel
    assert _fake_card(fl).warm_exec() is True
    assert fake_nvcc == [["probe_classify", "commit_step", "sharer_reductions"]]
    assert set(build._libs) == set(fake_nvcc[0])


# ---- the shared budget -----------------------------------------------------


def test_shared_lru_budget_spans_warm_and_exec(tmp_path):
    root = str(tmp_path)
    exec_root = os.path.join(root, "exec")
    os.makedirs(exec_root)

    def put(path, size, mtime):
        with open(path, "wb") as f:
            f.write(b"x" * size)
        with open(path[: path.rfind(".")] + ".json", "w") as f:
            f.write("{}")
        os.utime(path, (mtime, mtime))

    put(os.path.join(root, "warm-old.npz"), 400, 1000)
    put(os.path.join(exec_root, "exec-old.bin"), 400, 2000)
    put(os.path.join(root, "warm-new.npz"), 400, 3000)
    put(os.path.join(exec_root, "exec-new.bin"), 400, 4000)
    assert t_ck.prune_warm_cache(root, max_bytes=900) == 2
    # LRU across both pools: the two oldest went, one from each, sidecars too
    assert not os.path.exists(os.path.join(root, "warm-old.npz"))
    assert not os.path.exists(os.path.join(exec_root, "exec-old.bin"))
    assert not os.path.exists(os.path.join(exec_root, "exec-old.json"))
    assert os.path.exists(os.path.join(root, "warm-new.npz"))
    assert os.path.exists(os.path.join(exec_root, "exec-new.bin"))
    assert os.path.exists(os.path.join(exec_root, "exec-new.json"))


def test_write_entry_prunes(fake_nvcc, monkeypatch):
    """A build that lands an entry re-applies the shared budget at once;
    the libraries still serve this process. The budget is --cache-budget
    first, then $PRIMETPU_CACHE_MAX_BYTES."""
    monkeypatch.setenv("PRIMETPU_CACHE_MAX_BYTES", "1")
    cache = exec_cache.configure(True)
    assert len(build.libraries()) == 4 and cache.stats["misses"] == 4
    assert not _entries(cache.root) and not _entries(cache.root, ".json")
    build._libs.clear()
    monkeypatch.setenv("PRIMETPU_CACHE_MAX_BYTES", str(1 << 30))
    t_dp.configure(budget_bytes=1)
    cache = exec_cache.configure(True)
    build.libraries()
    assert cache.stats["misses"] == 4 and not _entries(cache.root)


# ---- fsck -------------------------------------------------------------------


def test_fsck_checks_port_entries(fake_nvcc, tmp_path):
    _build_entries("kernel")
    _build_entries("shim")
    root = str(tmp_path / "cache")
    res = run_fsck(root)
    assert res.checked["exec_entries"] == 5 and not res.findings
    victim = os.path.join(root, "exec", _entries(os.path.join(root, "exec"))[0])
    with open(victim, "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    res = run_fsck(root)
    assert [(f.kind, f.corrupt) for f in res.findings] == [("exec-cache", True)]
    res = run_fsck(root, repair="quarantine")
    assert not os.path.exists(victim)
    assert os.path.exists(os.path.join(root, ".fsck-quarantine", "exec",
                                       os.path.basename(victim)))


def test_fsck_sidecar_key_content_agreement(fake_nvcc, tmp_path, monkeypatch):
    """An edited payload no longer hashes to its address; a body that
    holds another entry's library is corrupt; an entry addressed under
    another toolchain is a dead address (a note, not corruption); and
    the JAX package's fsck, which knows only its own executable entries,
    finds a port entry's payload without `jax`/`jaxlib` fields."""
    cache = exec_cache.configure(True)
    build.libraries()
    root = str(tmp_path / "cache")
    key = cache.keys["probe_classify"]
    sidecar = os.path.join(cache.root, key + ".json")
    with open(sidecar) as f:
        meta = json.load(f)
    good = json.dumps(meta)
    meta["payload"]["entry"] = "tampered"
    with open(sidecar, "w") as f:
        json.dump(meta, f)
    (f1,) = run_fsck(root).findings
    assert f1.corrupt and "hash" in f1.detail
    with open(sidecar, "w") as f:
        f.write(good)
    # another entry's body under this address
    other = os.path.join(cache.root, cache.keys["commit_step"] + ".bin")
    shutil.copy(other, os.path.join(cache.root, key + ".bin"))
    (f2,) = run_fsck(root).findings
    assert f2.corrupt and "commit_step" in f2.detail
    shutil.copy(other, os.path.join(tmp_path, "keep.bin"))
    # built under another nvcc: correctly addressed, never read again here
    drift = dict(json.loads(good)["payload"], nvcc="release 11.8, V11.8.89")
    k2 = exec_cache.exec_key(drift)
    body = exec_cache.read_entry(os.path.join(tmp_path, "keep.bin"))
    cache._write_entry(k2, drift, {**body, "entry": "probe_classify", "key": k2})
    os.remove(os.path.join(cache.root, key + ".bin"))
    os.remove(sidecar)
    res = run_fsck(root)
    (f3,) = res.findings
    assert not f3.corrupt and f3.repairable and "dead address" in f3.detail
    assert "release 11.8" in f3.detail and res.clean
    jres = jax_fsck(root)
    assert jres.checked["exec_entries"] == 4
    assert all(f.corrupt and "missing version field(s): jax, jaxlib" in f.detail
               for f in jres.findings) and len(jres.findings) == 4


# ---- ENOSPC and chaos at exec_cache.write -----------------------------------


@pytest.fixture(scope="module")
def jax_ref():
    je = JEngine(_cfg(), _trace(), chunk_steps=16)
    je.run_chunked()
    return je


def _cpu_run():
    eng = Engine(port_cfg(_cfg()), port_trace(_trace()), chunk_steps=16, device="cpu")
    eng.overlap = True
    eng.run()
    return eng


def test_exec_cache_write_enospc_degrades_to_a_rebuild(fake_nvcc, jax_ref):
    """ENOSPC at the store (the disk-pressure probe says full through the
    whole ladder): the libraries built serve this process, each save
    degrades to a `save` warning, no temp file is left, the next process
    rebuilds, and the run is the JAX run."""
    t_sites.install(t_plan.FaultPlan(seed=0, events=(t_plan.FaultEvent(
        site="disk.preflight", occurrence=1, action="enospc_window",
        args=(("calls", 500),)),)))
    cache = exec_cache.configure(True)
    assert len(build.libraries()) == 4
    t_sites.deactivate()
    assert [w["stage"] for w in cache.warnings] == ["save"] * 4
    assert "DiskPressureError" in cache.warnings[0]["error"]
    assert not [n for n in os.listdir(cache.root) if n.endswith(".tmp")] and not _entries(cache.root)
    build._libs.clear()
    again = exec_cache.configure(True)
    build.libraries()
    assert again.stats["misses"] == 4 and len(_entries(again.root)) == 4
    assert_engines_equal(jax_ref, _cpu_run(), "enospc")


@pytest.mark.parametrize("action", j_plan.ACTIONS["durable"])
def test_a_jax_plan_at_exec_cache_write_fires_in_the_port(action, fake_nvcc, jax_ref):
    """A plan the JAX package writes, naming `exec_cache.write`, fires in
    the port at the entry's durable write. `delay` only stalls it;
    `torn`, `fsync_fail` and `enospc` crash the writer before the atomic
    replace (a simulated process death, as in the JAX package), leaving
    no entry and no temp file, and the next process rebuilds. The run
    ends bit-exact with the JAX run either way."""
    jplan = j_plan.FaultPlan(seed=3, events=(j_plan.FaultEvent(
        site="exec_cache.write", occurrence=1, action=action),))
    rt = t_sites.install(t_plan.FaultPlan.from_dict(json.loads(json.dumps(jplan.as_dict()))))
    cache = exec_cache.configure(True)
    if action == "delay":
        build.libraries()
        assert len(_entries(cache.root)) == 4
    else:
        with pytest.raises(t_sites.ChaosCrash, match="exec_cache.write"):
            build.libraries()
        assert not _entries(cache.root)
        assert not [n for n in os.listdir(cache.root) if n.endswith(".tmp")]
        t_sites.deactivate()
        build._libs.clear()
        again = exec_cache.configure(True)
        build.libraries()
        assert again.stats["misses"] == 4 and len(_entries(again.root)) == 4
    assert [e["site"] for e in rt.injected] == ["exec_cache.write"]
    assert_engines_equal(jax_ref, _cpu_run(), action)


# ---- the CLI ------------------------------------------------------------------

SPEC = "fft_like:n_phases=1,points_per_core=16"
RUNG1 = os.path.join(REPO, "configs", "rung1_64core_fft.json")


def _cli(args, tmp_path):
    r = subprocess.run([sys.executable, "-m", "primesim_tpu_torch", *args, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PRIMETPU_CACHE_DIR": str(tmp_path / "c")})
    assert r.returncode == 0, r.stderr
    return r


def test_cli_prints_the_cache_lines_only_when_on(tmp_path):
    """`--exec-cache on` adds `primetpu`'s time_to_first_step line before
    the run and its exec_cache line after it (and the port's stderr line);
    `--exec-cache off` prints exactly what no flag prints, but for walls."""
    run = ["run", RUNG1, "--synth", SPEC, "--fold", "--chunk-steps", "16"]
    plain, off, on = (_cli(run + f, tmp_path) for f in
                      ([], ["--exec-cache", "off"], ["--exec-cache", "on"]))

    def lines(r):
        out = [json.loads(ln) for ln in r.stdout.splitlines()]
        for ln in out:
            ln.pop("value")
            ln["detail"].pop("wall_s", None)
        return out

    assert lines(plain) == lines(off) and "exec_cache" not in plain.stderr + off.stderr
    got = lines(on)
    assert [ln["metric"] for ln in got] == ["time_to_first_step", "simulated_MIPS", "exec_cache"]
    assert got[1] == lines(plain)[0]
    assert got[0]["detail"] == {"cold": False, "compile_wall_s": 0.0, "load_wall_s": 0.0}
    assert got[2]["detail"] == {"hits": 0, "misses": 0, "memo_hits": 0, "errors": 0,
                                "compile_wall_s": 0.0, "load_wall_s": 0.0}
    assert "exec_cache: device cpu, " in on.stderr
    sweep = ["sweep", RUNG1, "--synth", SPEC, "--fold", "--vary", "llc_lat=20",
             "--exec-cache", "on", "--overlap", "on"]
    got = [json.loads(ln)["metric"] for ln in _cli(sweep, tmp_path).stdout.splitlines()]
    assert got == ["time_to_first_step", "simulated_MIPS", "fleet_aggregate_MIPS", "exec_cache"]


def test_flags_are_where_primetpu_has_them():
    from primesim_tpu_torch.cli import build_parser

    p = build_parser()
    for verb, extra in (("run", ["cfg.json"]), ("sweep", ["cfg.json"]),
                        ("worker", ["--connect", "s", "--worker-id", "w"])):
        ns = p.parse_args([verb, *extra])
        assert (ns.exec_cache, ns.overlap) == ("off", "off")
        ns = p.parse_args([verb, *extra, "--exec-cache", "on", "--overlap", "on",
                           "--cache-budget", "5"])
        assert (ns.exec_cache, ns.overlap, ns.cache_budget) == ("on", "on", 5)
    ns = p.parse_args(["serve", "cfg.json", "--state-dir", "d", "--exec-cache", "on"])
    assert ns.exec_cache == "on" and not hasattr(ns, "overlap")
    with pytest.raises(SystemExit):
        p.parse_args(["serve", "cfg.json", "--state-dir", "d", "--overlap", "on"])
    with pytest.raises(SystemExit):
        p.parse_args(["run", "cfg.json", "--exec-cache", "maybe"])


def test_pooled_sweep_and_dispatch_pass_the_flags_on(monkeypatch):
    """`sweep --workers` gives its workers both flags; a dispatching
    daemon gives its autoscaled workers `--exec-cache on` when its cache
    is on."""
    from types import SimpleNamespace

    from primesim_tpu_torch.pool import campaign
    from primesim_tpu_torch.serve import dispatch

    argv = []
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: argv.append(cmd) or
                        SimpleNamespace(pid=1, poll=lambda: None))
    ns = SimpleNamespace(warm_cache="off", exec_cache="on", overlap="on", lease_ttl=5.0)
    campaign._spawn_worker(ns, "sock", "w0", torch.device("cpu"))
    cmd = argv.pop()
    assert cmd[cmd.index("--exec-cache") + 1] == "on" and cmd[cmd.index("--overlap") + 1] == "on"
    d = object.__new__(dispatch.DispatchScheduler)
    d.__dict__.update(spawn=True, _workers=[], max_workers=1, queue=["j"], dispatched=set(),
                      _last_worker_spawn_t=0.0, _worker_seq=0, pool_socket="sock",
                      lease_ttl_s=5.0, device=torch.device("cpu"),
                      _serve_event=lambda *a, **k: None)
    for on in (False, True):
        exec_cache.configure(on)
        d._workers, d._last_worker_spawn_t = [], 0.0
        d._autoscale(100.0)
        cmd = argv.pop()
        assert ("--exec-cache" in cmd) == on
        if on:
            assert cmd[cmd.index("--exec-cache") + 1] == "on"
