"""Build the CUDA kernels in `csrc/` and bind them through ctypes.

Each `csrc/<name>.cu` compiles on first use, with one `nvcc` per source
and all of them started together, into its own shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<key>/lib<name>.so <name>.cu

`<key>` hashes the sources, the shared header and the flags, so an edited
kernel rebuilds and an unchanged one loads the library already built.
ptxas's report (registers, shared memory, spills) is kept beside each
library as `<name>.log`. Every C entry point returns `cudaGetLastError()`
after its launch; `launch` raises on a non-zero code and otherwise adds
one to the kernel's count in `LAUNCHES`. A missing `nvcc`, a failed build
or a failed load raises: nothing falls back.

With the kernel build cache on (`sim/exec_cache.py`, `--exec-cache on`)
`libraries` and `library` take each library from the cache's entry
under `$PRIMETPU_CACHE_DIR/exec` instead, building the missing ones
with the same `nvcc` command into a private directory; `_build/` is not
touched then.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("probe_classify", "commit_step", "sharer_reductions", "router_cascade")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}

# kernel launches since the counts were last set to 0; `launch` is the
# only writer
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_key() -> str:
    """sha256 of the nvcc flags and every kernel source and header: what
    a build is keyed by, and the `kernels` field of the attestation
    toolchain fingerprint."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def build_dir() -> Path:
    return BUILD_ROOT / source_key()[:16]


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """The `release` line of `nvcc --version` (the toolchain a library
    was built with: a field of the build cache's key)."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    rel = [ln for ln in lines if "release" in ln]
    return (rel or lines or ["unknown"])[-1]


def compile_into(out: Path, names) -> float:
    """Compile the kernels `names` into `out` with one `nvcc` per source,
    all started together: `out/lib<name>.so` and `out/<name>.log` (the
    ptxas report). Returns the wall seconds; raises if one failed."""
    import time

    t0 = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in names:
        tmp = out / f"lib{k}.so.{os.getpid()}.tmp"
        log = open(out / f"{k}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{k}.cu")]
        procs.append((k, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, cwd=CSRC)))
    failed = []
    for k, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc:
            failed.append(k)
        else:
            os.replace(tmp, out / f"lib{k}.so")
    if failed:
        logs = "\n".join((out / f"{k}.log").read_text() for k in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def build() -> Path:
    """Compile every kernel whose library is not built yet, in parallel;
    returns the build directory."""
    out = build_dir()
    todo = [k for k in KERNELS if not (out / f"lib{k}.so").exists()]
    if todo:
        compile_into(out, todo)
    return out


def libraries(names=KERNELS) -> dict[str, ctypes.CDLL]:
    """Load the kernels `names` (building what is missing, in parallel):
    from `_build/`, or through the kernel build cache when one is on."""
    from ..sim import exec_cache

    cache = exec_cache.active()
    if cache is not None:
        _libs.update(cache.kernel_libraries(names))
    else:
        todo = [k for k in names if k not in _libs]
        if todo:
            out = build()
            for k in todo:
                _libs[k] = ctypes.CDLL(str(out / f"lib{k}.so"))
    return {k: _libs[k] for k in names}


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        libraries([name])
    return _libs[name]


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` lines of a built kernel (registers, spills): from
    its cache entry when the build cache is on."""
    from ..sim import exec_cache

    cache = exec_cache.active()
    if cache is not None and name in cache.reports:
        text = cache.reports[name]
    else:
        log = build_dir() / f"{name}.log"
        text = log.read_text() if log.exists() else ""
    return "; ".join(ln.strip() for ln in text.splitlines() if "ptxas info" in ln)


def launch(name: str, pointers, ints, stream) -> None:
    """Call `<name>_launch(pointers..., ints..., stream)`, raise if the
    launch reported a CUDA error, and count it in `LAUNCHES`."""
    lib = library(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:  # declared once per kernel
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * len(pointers)
            + [ctypes.c_int] * len(ints)
            + [ctypes.c_void_p]
        )
    rc = fn(*[t.data_ptr() for t in pointers], *ints, stream.cuda_stream)
    if rc:
        err = lib.psim_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {rc}: {err(rc).decode()}")
    LAUNCHES[name] += 1
