"""The execution-capture bridge: build and drive the LD_PRELOAD frontend,
the JAX package's `ingest/capture.py` for the port.

`build_shim` compiles the port's own copy of the capture shim
(`frontend/ptpu_capture.cpp`) with the host's C++ compiler into the
git-ignored `_build/` directory beside the package, keyed by a hash of
the source and the flags as the kernels are, never into the source
directory. `capture_run` runs a real multithreaded binary under it and
loads the PTPU v4 trace it writes; `capture_online` starts the binary in
the shim's shared-memory ring mode and hands back the `RingSource` that
`ingest.ring.OnlineEngine` simulates while the binary runs.

    from primesim_tpu_torch.ingest.capture import capture_run
    trace = capture_run(["./my_pthread_app", "args"], line=64)
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from ..trace.format import Trace

FRONTEND = Path(__file__).resolve().parent.parent / "frontend"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


def build_shim(out_dir: str | None = None, cxx: str = "g++") -> str:
    """Compile the capture shim unless a build of this source with these
    flags exists; returns the .so path. The library is written under a
    temporary name and renamed into place, so two processes building at
    once never load a half-written file."""
    src = FRONTEND / "ptpu_capture.cpp"
    if out_dir is None:
        h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode() + src.read_bytes())
        out_dir = str(BUILD_ROOT / f"capture-{h.hexdigest()[:16]}")
    so = os.path.join(out_dir, "libptpu_capture.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(src), "-ldl", "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, so)
    return so


def capture_run(
    cmd: list[str],
    *,
    trace_out: str | None = None,
    capture_memops: bool = True,
    line: int = 64,
    max_cores: int = 256,
    max_events: int = 1 << 20,
    memop_max_lines: int = 64,
    timeout: float | None = 120.0,
    env: dict[str, str] | None = None,
) -> Trace:
    """Run `cmd` under the capture shim and return the captured Trace."""
    so = build_shim()
    tmp = None
    if trace_out is None:
        fd, tmp = tempfile.mkstemp(suffix=".ptpu")
        os.close(fd)
        trace_out = tmp
    run_env = dict(os.environ if env is None else env)
    preload = run_env.get("LD_PRELOAD", "")
    run_env.update(
        LD_PRELOAD=(so + (" " + preload if preload else "")),
        PTPU_TRACE_OUT=trace_out,
        PTPU_CAPTURE_MEMOPS="1" if capture_memops else "0",
        PTPU_LINE=str(line),
        PTPU_MAX_CORES=str(max_cores),
        PTPU_MAX_EVENTS=str(max_events),
        PTPU_MEMOP_MAX_LINES=str(memop_max_lines),
    )
    try:
        proc = subprocess.run(
            cmd, env=run_env, timeout=timeout, capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"capture_run: {cmd!r} exited {proc.returncode}\n"
                f"stderr:\n{proc.stderr}"
            )
        return Trace.load(trace_out)
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def capture_online(
    cmd: list[str],
    *,
    n_cores: int,
    ring_path: str | None = None,
    capture_memops: bool = True,
    line: int = 64,
    max_cores: int = 256,
    ring_records: int = 1 << 16,
    memop_max_lines: int = 64,
    retain_history: bool = True,
    env: dict[str, str] | None = None,
):
    """Launch `cmd` under the capture shim in shared-memory ring mode and
    return (process, RingSource): feed the source to
    `ingest.ring.OnlineEngine` to simulate WHILE the target runs. The
    caller owns both: wait() the process and close() the source when the
    simulation returns. `retain_history` keeps the whole stream for
    `to_trace()`; pass False for long captures (memory then stays
    bounded by the unconsumed backlog)."""
    from .ring import RingSource

    so = build_shim()
    if ring_path is None:
        fd, ring_path = tempfile.mkstemp(suffix=".ptpuring")
        os.close(fd)
    run_env = dict(os.environ if env is None else env)
    preload = run_env.get("LD_PRELOAD", "")
    run_env.update(
        LD_PRELOAD=(so + (" " + preload if preload else "")),
        PTPU_RING_OUT=ring_path,
        PTPU_RING_RECORDS=str(ring_records),
        PTPU_CAPTURE_MEMOPS="1" if capture_memops else "0",
        PTPU_LINE=str(line),
        PTPU_MAX_CORES=str(max_cores),
        PTPU_MEMOP_MAX_LINES=str(memop_max_lines),
    )
    proc = subprocess.Popen(
        cmd, env=run_env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        # the mkstemp ring file is ours: RingSource.close() unlinks it
        src = RingSource(ring_path, n_cores, unlink_on_close=True,
                         retain_history=retain_history)
    except Exception:
        proc.kill()
        raise
    return proc, src
