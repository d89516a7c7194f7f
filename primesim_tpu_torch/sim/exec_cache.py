"""The kernel build cache: the JAX package's `sim/exec_cache.py` for the
port.

The JAX package caches its compiled XLA programs; the port compiles no
program of its own, only its `nvcc` kernel libraries
(`kernels/build.py`) and the `g++` capture shim (`ingest/capture.py`),
so those are what this cache holds. With the cache on, a process takes
each library from `$PRIMETPU_CACHE_DIR/exec/<key>.bin`, written by an
earlier process on the same toolchain, instead of running `nvcc`; with
it off (the default) `kernels/build.py` builds into the package's
`_build/` directory as it always did.

Entries. One per library: `entry` is the kernel's name, or `capture`
for the shim (an entry the JAX cache has no counterpart of). The
address is the sha256 of a canonical-JSON payload:

  - this module's `_FORMAT` and the checkpoint `_FORMAT`;
  - the backend (`cuda`; `host` for the shim) and the card count;
  - the entry's name;
  - torch's and CUDA's versions;
  - `nvcc`: the `release` line of `nvcc --version` (for the shim the
    first line of the C++ compiler's `--version`);
  - `arch`: `sm_90a` (for the shim the host's machine type);
  - `kernels`: `build.source_key()`, the hash of the flags and every
    kernel source that the attestation fingerprint (`attest/chain.py`)
    carries too (for the shim its own source key).

No machine geometry enters the key: the kernels take every shape and
mode as a launch argument, so one entry serves every machine (the JAX
key hashes the normalized geometry, because an XLA program is
specialized to its shapes).

Format. `<key>.bin` is the JAX package's framing: the magic `PTEXEC01`,
the CRC-32 of the body, then the body, a pickled dict whose `payload`
is the library's bytes, with its ptxas report (`ptxas`), `entry` and
`key`. Beside it a `<key>.json` sidecar holds `{key, payload, size}`, so
`fsck` can re-derive the address offline. Writes go through a
writer-unique temp file, fsync, the chaos site `exec_cache.write` and
an atomic replace, after a disk-pressure preflight; then the shared LRU
budget (`checkpoint.prune_warm_cache`, warm `.npz` and exec `.bin`
entries as one pool) is enforced.

Loads verify the magic, the CRC and the unpickling before any byte
reaches `ctypes.CDLL`: dlopen of a truncated library can kill the
process, which no `except` catches. The verified bytes are written to a
file private to this process and loaded from there; the entry's mtime is
touched (use order for the LRU). A corrupt, truncated, bad-magic, stale
or unwritable entry costs a warning (`warnings`, with `stage` one of
`key`, `load`, `compile`, `save` or `execute`) and a rebuild, never the
run, and never the plain torch version: a missing compiler on a miss
still raises, as `kernels/build.py` does. The shim is never loaded into
this process (its exit hook would write a trace): its verified copy is
what the captured program preloads.

Activation is process-global (`configure`, `active`), so every load site
(the engines, the CLI, pool workers, serve buckets) routes through one
flag.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import logging
import os
import pickle
import platform
import shutil
import struct
import tempfile
import time
import zlib
from pathlib import Path

from ..chaos import sites as chaos

log = logging.getLogger("primetpu.exec_cache")

_MAGIC = b"PTEXEC01"
_FORMAT = 1  # entry layout; combined with checkpoint._FORMAT in the key
ARCH = "sm_90a"
SHIM = "capture"  # the capture shim's entry


class ExecCacheCorrupt(Exception):
    """A `.bin` entry that cannot be trusted: bad magic, CRC mismatch,
    truncation, an unpicklable body or another entry's body. Treated as
    a miss."""


def exec_cache_root() -> str:
    """`$PRIMETPU_CACHE_DIR/exec` (or the per-user default's `exec/`):
    a sibling pool of the warm-state entries, so both share one tree and
    one LRU budget. Created on first use."""
    from .checkpoint import warm_cache_root

    root = os.path.join(warm_cache_root(), "exec")
    os.makedirs(root, exist_ok=True)
    return root


def exec_key_payload(entry: str, cxx: str = "g++") -> dict:
    """The canonical key payload of one library (module docstring)."""
    import torch

    from . import checkpoint as ckpt

    if entry == SHIM:
        from ..ingest import capture

        backend, devices = "host", 0
        tool, arch, src = (capture.compiler_version(cxx), platform.machine(),
                           capture.shim_source_key(cxx))
    else:
        from ..kernels import build

        if entry not in build.KERNELS:
            raise ValueError(f"no kernel named {entry!r}")
        backend, devices = "cuda", int(torch.cuda.device_count())
        tool, arch, src = build.nvcc_version(), ARCH, build.source_key()
    return {
        "exec_format": _FORMAT,
        "ckpt_format": int(ckpt._FORMAT),
        "backend": backend,
        "devices": devices,
        "entry": entry,
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda or "none"),
        "nvcc": tool,
        "arch": arch,
        "kernels": src,
    }


def exec_key(payload: dict) -> str:
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


def read_entry(bin_path: str) -> dict:
    """The verified body of one `.bin` entry: magic, CRC and unpickling
    checked, and a body that holds a library's bytes; raises
    ExecCacheCorrupt otherwise (FileNotFoundError when absent)."""
    with open(bin_path, "rb") as f:
        record = f.read()
    head = len(_MAGIC) + 4
    if len(record) < head or record[: len(_MAGIC)] != _MAGIC:
        raise ExecCacheCorrupt(f"{bin_path}: bad magic / truncated")
    (crc,) = struct.unpack("<I", record[len(_MAGIC):head])
    body = record[head:]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ExecCacheCorrupt(f"{bin_path}: CRC mismatch")
    try:
        blob = pickle.loads(body)
    except Exception as e:
        raise ExecCacheCorrupt(f"{bin_path}: undecodable body: {e}") from e
    if not isinstance(blob, dict) or not isinstance(blob.get("payload"), bytes):
        raise ExecCacheCorrupt(f"{bin_path}: not an exec entry")
    return blob


class ExecCache:
    """One process's view of the on-disk library pool: the libraries it
    loaded (by key), their ptxas reports (by entry), hit, miss and wall
    accounting, and structured warnings."""

    def __init__(self, root: str | None = None):
        self.root = root or exec_cache_root()
        self._memo: dict[str, ctypes.CDLL] = {}
        self._shim: dict[str, str] = {}  # key -> the shim's private file
        self._private: str | None = None  # where verified bytes are loaded from
        self.keys: dict[str, str] = {}  # entry -> its key in this process
        self.reports: dict[str, str] = {}  # entry -> ptxas report
        self.warnings: list[dict] = []
        self.stats = {
            "hits": 0,           # disk loads (no compiler run)
            "misses": 0,         # builds (the entry then persisted)
            "memo_hits": 0,      # reuse in this process, no disk touch
            "errors": 0,         # warnings: a rebuild or an unsaved entry
            "compile_wall_s": 0.0,  # the compiler's wall
            "load_wall_s": 0.0,
        }

    # ---- public entry points --------------------------------------------

    def kernel_libraries(self, names) -> dict[str, ctypes.CDLL]:
        """The kernel libraries `names`: from this process's memo, from
        their entries, or built together (one `nvcc` per source, all
        started at once) and persisted."""
        out, todo = {}, []
        for k in names:
            key, payload = self._key(k)
            lib = self._memo.get(key) if key else None
            if lib is not None:
                self.stats["memo_hits"] += 1
                out[k] = lib
                continue
            lib = self._load(key, k) if key else None
            if lib is None:
                todo.append((k, key, payload))
            else:
                out[k] = lib
        if todo:
            out.update(self._build_kernels(todo))
        return out

    def shim_path(self, cxx: str = "g++") -> str:
        """A copy of the capture shim for the captured program's
        LD_PRELOAD (the shim is never loaded into this process): from its
        verified entry, or built with `cxx` and persisted; the file is
        private to this process and removed at its exit."""
        key, payload = self._key(SHIM, cxx)
        if key and key in self._shim:
            self.stats["memo_hits"] += 1
            return self._shim[key]
        path = self._load(key, SHIM) if key else None
        if path is None:
            from ..ingest import capture

            path = os.path.join(tempfile.mkdtemp(dir=self._private_dir()),
                                "libptpu_capture.so")
            t0 = time.perf_counter()
            try:
                capture.compile_shim(path, cxx)
            except Exception as e:
                self._fallback("compile", SHIM, key, e)
                raise
            self._built(time.perf_counter() - t0, 1)
            if key:
                with open(path, "rb") as f:
                    self._save(key, payload, SHIM, f.read(), "")
        if key:
            self._shim[key] = path
        return path

    # ---- lookup / build -------------------------------------------------

    def _key(self, entry: str, cxx: str = "g++"):
        try:
            payload = exec_key_payload(entry, cxx)
            key = exec_key(payload)
        except Exception as e:
            self._fallback("key", entry, None, e)
            return None, None
        self.keys[entry] = key
        return key, payload

    def _load(self, key: str, entry: str):
        """The entry's library, loaded from verified bytes (the shim: the
        path of its private copy), or None on a miss."""
        t0 = time.perf_counter()
        try:
            blob = read_entry(self._paths(key)[0])
            if blob.get("key", key) != key or blob.get("entry", entry) != entry:
                raise ExecCacheCorrupt(f"{key}.bin holds {blob.get('entry')} "
                                       f"under {str(blob.get('key'))[:12]}…")
        except FileNotFoundError:
            return None  # plain miss
        except Exception as e:
            self._fallback("load", entry, key, e)
            return None  # corrupt or stale: rebuild
        path = os.path.join(tempfile.mkdtemp(dir=self._private_dir()),
                            "libptpu_capture.so" if entry == SHIM else f"lib{entry}.so")
        with open(path, "wb") as f:
            f.write(blob["payload"])
        lib = None
        if entry != SHIM:  # the shim is loaded by the programs it captures
            try:
                lib = self._dlopen(path, entry)
            except Exception as e:
                self._fallback("execute", entry, key, e)
                return None
            finally:
                shutil.rmtree(os.path.dirname(path), ignore_errors=True)  # mapped already
            self._memo[key] = lib
        self.reports[entry] = str(blob.get("ptxas", ""))
        self.stats["hits"] += 1
        self.stats["load_wall_s"] += time.perf_counter() - t0
        try:
            os.utime(self._paths(key)[0], None)  # LRU: mtime is use order
        except OSError:
            pass
        return path if entry == SHIM else lib

    def _build_kernels(self, todo) -> dict[str, ctypes.CDLL]:
        from ..kernels import build

        names = [k for k, _, _ in todo]
        tmp = Path(tempfile.mkdtemp(prefix="primetpu-build-"))
        try:
            try:
                wall = build.compile_into(tmp, names)
            except Exception as e:
                for k, key, _ in todo:
                    self._fallback("compile", k, key, e)
                raise
            self._built(wall, len(names))
            out = {}
            for k, key, payload in todo:
                so = tmp / f"lib{k}.so"
                log_path = tmp / f"{k}.log"
                report = log_path.read_text() if log_path.exists() else ""
                self.reports[k] = report
                if key:
                    self._save(key, payload, k, so.read_bytes(), report)
                out[k] = self._dlopen(str(so), k)
                if key:
                    self._memo[key] = out[k]
            return out
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _built(self, wall: float, n: int) -> None:
        self.stats["misses"] += n
        self.stats["compile_wall_s"] += wall

    @staticmethod
    def _dlopen(path: str, entry: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        getattr(lib, f"{entry}_launch")  # the symbol the wrapper binds
        return lib

    def _private_dir(self) -> str:
        if self._private is None:
            self._private = tempfile.mkdtemp(prefix="primetpu-exec-")
            atexit.register(shutil.rmtree, self._private, True)
        return self._private

    # ---- on-disk format -------------------------------------------------

    def _paths(self, key: str) -> tuple[str, str]:
        return (os.path.join(self.root, f"{key}.bin"),
                os.path.join(self.root, f"{key}.json"))

    def _save(self, key: str, payload: dict, entry: str, data: bytes, report: str) -> None:
        """Persist a freshly built library; a failure costs a warning and
        the next process a rebuild, never this run."""
        try:
            self._write_entry(key, payload, {"payload": data, "ptxas": report,
                                             "entry": entry, "key": key})
        except Exception as e:
            self._fallback("save", entry, key, e)

    def _write_entry(self, key: str, payload: dict, blob: dict) -> None:
        from .checkpoint import prune_warm_cache

        body = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
        record = _MAGIC + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF) + body
        os.makedirs(self.root, exist_ok=True)
        bin_path, meta_path = self._paths(key)
        self._atomic_write(bin_path, record)
        meta = {"key": key, "payload": payload, "size": len(record)}
        self._atomic_write(meta_path, json.dumps(meta).encode())
        # shared LRU budget: the warm .npz pool and this .bin pool
        prune_warm_cache(os.path.dirname(self.root))

    def _atomic_write(self, dst: str, data: bytes) -> None:
        from ..util import diskpressure

        # a DiskPressureError here unwinds into _save: an entry that
        # cannot be persisted costs a rebuild later, never the run
        diskpressure.preflight(dst, len(data), kind="exec-cache")
        # writer-unique temp name: processes building the same entry at
        # once must not rename each other's file away mid-write
        fd, tmp = tempfile.mkstemp(
            dir=self.root, prefix=os.path.basename(dst) + ".", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            chaos.durable("exec_cache.write", path=tmp)
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # ---- structured warnings --------------------------------------------

    def _fallback(self, stage: str, entry: str, key, err) -> None:
        rec = {
            "stage": stage,
            "entry": entry,
            "key": key,
            "error": f"{type(err).__name__}: {err}",
        }
        self.warnings.append(rec)
        self.stats["errors"] += 1
        log.warning("kernel build cache: %s", json.dumps(rec, sort_keys=True))


# ---- process-global activation ---------------------------------------------

_ACTIVE: ExecCache | None = None


def configure(enabled: bool, root: str | None = None) -> ExecCache | None:
    """Turn the process-global cache on or off (the load sites consult
    `active()`, so one flag covers the whole process)."""
    global _ACTIVE
    _ACTIVE = ExecCache(root) if enabled else None
    return _ACTIVE


def active() -> ExecCache | None:
    return _ACTIVE
