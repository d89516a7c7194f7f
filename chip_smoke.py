#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (primesim_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the final line:

1. device    -- a CUDA card is required; prints nvidia-smi's name and
                power limit.
2. build     -- compiles the kernels in primesim_tpu_torch/csrc/ with
                nvcc (one process per source, in parallel).
3. kernels   -- each kernel against its plain PyTorch version on the card,
                exactly (integer simulator: tolerance 0), on random inputs:
                the three step kernels at the headline shapes with sharer
                words using bit 31, router_cascade at rung 3's (1024
                cores, 62 hops) with and without the barrier-arrival leg,
                about half the hops masked and link clocks at the clamp.
4. rung1     -- configs/rung1_64core_fft.json on fft_like(64, n_phases=2,
                points_per_core=32, seed=7): the card's run launches each
                of its kernels once per step, equals the port's CPU run in
                every state field and equals the committed JAX fixture.
5. capture   -- the first 512 steps (one chunk) of the headline machine
                and of rung 3 on the card, each equal to the port's CPU run
                of them in per-core cycles, all 26 counters and every state
                field. Meanwhile the kernel inputs staged at steps 1 and 300
                (headline) and 1 and 500 (rung 3's router_cascade) are kept;
                each kernel equals its plain version on them. Each kernel
                is then timed alone on the later step's inputs (converted
                beforehand, so that the wrapper launches the one kernel and
                nothing else, which phase 8 confirms) with CUDA events:
                median of 25 after warm-up, each launch queued behind a
                device sleep so host overhead does not count.
6. headline  -- the first main path: 1024 cores / 1024 banks, 32x32 mesh,
                the folded fft_like(1024, 4 phases, 256 points, seed 42)
                trace, chunk_steps=512, run to completion through
                Engine.run with the launch counts set to 0 just before.
                Each of its three kernels must have launched once per step
                (router_cascade never), the instruction count must equal
                the trace's, the digest of the run (steps, per-core cycles,
                all 26 counters, final link and controller clocks) must
                equal the JAX package's committed one
                (primesim_tpu_torch/fixtures/headline.json), and the final
                state must pass the machine invariants.
7. rung3     -- the second main path: the shipped
                configs/rung3_1024core_o3.json (router NoC, DRAM queue, O3)
                on the same trace, likewise: all four kernels once per
                step, instructions, the digest against
                fixtures/rung3_headline.json, invariants.
8. profile   -- first, under torch.profiler, one wrapper call per kernel
                on the inputs phase 5 timed, each of which must run its
                kernel alone. Then one 64-step chunk of each main path
                from a mid-run state (steps 256-319): device busy time,
                device events per step, the device time by kernel name and
                each hand-written kernel's mean device time per launch
                (the profiler adds host overhead, so the window is not a
                speed figure).

Then the kernel summary line and, last, the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Integer ALU peak: the card's float32 rate outside the tensor cores
# (67 TFLOP/s); int32 issues at no more than that, so the bound stays a
# lower bound on time.
INT_OPS_PER_S = 67e12
KERNEL_META = {
    "probe_classify": ("primesim_tpu_torch/csrc/probe_classify.cu",
                       "primesim_tpu/kernels/step_kernels.py:258"),
    "commit_step": ("primesim_tpu_torch/csrc/commit_step.cu",
                    "primesim_tpu/kernels/step_kernels.py:475"),
    "sharer_reductions": ("primesim_tpu_torch/csrc/sharer_reductions.cu",
                          "primesim_tpu/kernels/reductions.py:103"),
    "router_cascade": ("primesim_tpu_torch/csrc/router_cascade.cu",
                       "primesim_tpu/kernels/router_kernels.py:103"),
}
STEP_KERNELS = ("probe_classify", "commit_step", "sharer_reductions")
RUNG3_STAGED = ("router_cascade",)  # staged from rung 3, the rest from the headline
CHECK_STEPS = 512  # steps of each main path that the CPU run repeats
CAPTURE = {"headline": (1, 300), "rung3": (1, 500)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "primesim_tpu_torch")):
        print("chip_smoke: primesim_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from primesim_tpu_torch import convert
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.kernels import build, reductions, router_kernels, step_kernels
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.sim.state import dirm_width, llc_meta_width
    from primesim_tpu_torch.stats.digest import run_digest
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.trace.format import fold_ins
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    mods = {"probe_classify": step_kernels, "commit_step": step_kernels,
            "sharer_reductions": reductions, "router_cascade": router_kernels}
    wrappers = {k: getattr(m, k) for k, m in mods.items()}
    plains = {k: getattr(m, f"{k}_plain") for k, m in mods.items()}

    def fixture(name):
        """A committed JAX reference: its machine, trace and record."""
        with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", f"{name}.json")) as f:
            fx = json.load(f)
        spec = fx["config"]
        if isinstance(spec, str):
            with open(os.path.join(ROOT, spec)) as f:
                spec = json.load(f)
        tr = synth.GENERATORS[fx["trace"]["generator"]](**fx["trace"]["args"])
        return fx, MachineConfig.from_dict(spec), fold_ins(tr) if fx["trace"].get("fold") else tr

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(smi_line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi_line, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    build.build()
    for k in build.KERNELS:
        build.library(k)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": {k: build.ptxas_report(k) for k in build.KERNELS}})

    hfx, cfg, trace = fixture("headline")
    r3fx, cfg3, trace3 = fixture("rung3_headline")
    if trace3.events.tobytes() != trace.events.tobytes():
        fail("rung 3's fixture names another trace than the headline's")
    C, S1, W1 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways
    W2, NW = cfg.llc.ways, cfg.n_sharer_words
    MW, DW, FS = llc_meta_width(cfg), dirm_width(cfg), W1 * S1
    NS, rl = cfg.n_banks * cfg.llc.sets, cfg.local_run_len
    H3 = (cfg3.noc.mesh_x - 1) + (cfg3.noc.mesh_y - 1)
    max_err = {k: 0 for k in wrappers}

    def call(fn, name, args, kw=None):
        """A wrapper or plain version on staged arguments (the step
        kernels take the headline machine's config first)."""
        return fn(cfg, *args, **(kw or {})) if name in STEP_KERNELS else fn(*args, **(kw or {}))

    def same_run(phase, gpu, cpu):
        """Fail unless two engines agree in steps, per-core cycles, every
        counter and every state field; returns the card's state as numpy."""
        gs, cs = convert.state_to_numpy(gpu.state), convert.state_to_numpy(cpu.state)
        for f in gs:
            same = (all(np.array_equal(gs[f][k], cs[f][k]) for k in gs[f])
                    if f == "knobs" else np.array_equal(gs[f], cs[f]))
            if not same:
                fail(f"{phase}: state field {f} differs between the card and the CPU")
        if gpu.steps_run != cpu.steps_run or not np.array_equal(gpu.cycles, cpu.cycles):
            fail(f"{phase}: steps or cycles differ between the card and the CPU")
        gc, cc = gpu.counters, cpu.counters
        for k in cc:
            if not np.array_equal(gc[k], cc[k]):
                fail(f"{phase}: counter {k} differs between the card and the CPU")
        return gs

    def reset_launches():
        build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))

    def compare(name, args, kw=None):
        """The kernel (through its wrapper) against the plain version on
        the same card tensors; returns the kernel's outputs."""
        got = call(wrappers[name], name, args, kw)
        want = call(plains[name], name, args, kw)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                fail(f"{name}: the kernel and its plain version return different outputs")
            if g is not None:
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        max_err[name] = max(max_err[name], err)
        if err != 0:
            fail(f"{name}: kernel differs from its plain version by {err}")
        return got

    # ---- 3. kernels on random inputs at the main paths' shapes
    rng = np.random.default_rng(2026)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def words(shape):  # random 32-bit words, about half with bit 31 set
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)

    def dir_rows(n, n_lines):
        r = np.zeros((n, DW), np.int32)
        r[:, 0 : 2 * W2 : 2] = rng.integers(-1, n_lines, (n, W2))
        r[:, 1 : 2 * W2 : 2] = rng.integers(-1, C, (n, W2))
        r[:, 2 * W2 : 4 * W2] = rng.integers(0, 3, (n, 2 * W2))
        r[:, MW:] = words((n, W2 * NW))
        return r

    n_lines = 6
    line = rng.integers(0, n_lines, C)
    l1 = np.concatenate([
        rng.integers(-1, n_lines, (C, FS)), rng.integers(0, 4, (C, FS)),
        rng.integers(0, 4, (C, FS)), rng.integers(0, NS * W2, (C, FS)),
        rng.integers(0, 3, (C, FS)),
    ], axis=1)
    vrows = dir_rows(C * W1, n_lines).reshape(C, W1, DW)
    own = vrows[:, :, 1 : 2 * W2 : 2]  # a view: a third name the core itself
    pick = rng.random(own.shape) < 0.3
    own[pick] = np.broadcast_to(np.arange(C)[:, None, None], own.shape)[pick]
    cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
    cc, ww = np.nonzero(rng.random((C, W1)) < 0.5)
    vrows[cc, ww, 2 * (l1[cc, 3 * FS + cols[cc, ww]] % W2)] = l1[cc, cols[cc, ww]]
    run_cols = np.where(rng.random((C, rl)) < 0.5,
                        rng.integers(0, W1, (C, rl)) * S1 + (line & (S1 - 1))[:, None],
                        rng.integers(0, FS, (C, rl)))
    patch = [cu(rng.integers(0, 2, (C, rl))), cu(rng.integers(0, 2, (C, rl))), cu(run_cols)]
    cid = cu(np.arange(C))
    step_no = torch.tensor(777, dtype=torch.int32, device=dev)
    pc_out = compare("probe_classify", [
        cu(l1), cu(vrows.reshape(C, W1 * DW)), cu(dir_rows(C, n_lines)), cu(line),
        cid, step_no, *patch,
    ])
    flags = rng.integers(0, 2, (C, 18))
    lanes = np.stack([
        line, rng.integers(0, W1, C), rng.integers(0, W1, C), *flags[:, 3:9].T,
        rng.integers(0, 4, C), rng.integers(0, NS, C), rng.integers(0, W2, C),
        rng.integers(0, W2, C), *flags[:, 13:17].T, rng.integers(0, C, C),
    ], axis=1)
    compare("commit_step", [
        cu(rng.integers(-5, 50, (C, 5 * FS))),
        cu(rng.integers(-(2**31), 2**31, (C, DW), dtype=np.int64)),
        pc_out[0], cu(words((C, NW))), cu(lanes), cid, step_no,
        cu(rng.integers(-(2**31), 2**31, (26, C), dtype=np.int64)),
        cu(rng.integers(0, 2**30, (26, C))), *patch,
    ])
    compare("sharer_reductions", [
        cu(words((C, NW))), cu(words((C, NW))),
        cu(rng.integers(0, cfg.n_tiles, C)), cu(rng.integers(-1, C, C)),
        cu(rng.integers(0, 2, C)), cu(rng.integers(0, 2, C)), cid,
        torch.tensor(1, dtype=torch.int32, device=dev),
        torch.tensor(1, dtype=torch.int32, device=dev),
    ])
    for has_sync in (False, True):
        LT = (3 if has_sync else 2) * H3
        ok = rng.random((C, LT)) < 0.5
        lf = np.where(rng.random((C, LT)) < 0.3,
                      -(1 << 30) + rng.integers(0, 50, (C, LT)),  # at the clamp
                      rng.integers(-2000, 900_000, (C, LT)))
        bs = np.where(ok, rng.integers(-500, 900_000, (C, LT)), 2**31 - 1)
        hops = [cu(rng.integers(0, H3 + 1, C)) for _ in range(3)]
        compare("router_cascade", [
            cu(lf), cu(bs), cu(rng.integers(0, 60, (C, LT))),
            torch.from_numpy(ok).to(dev), cu(rng.integers(0, 900_000, C)),
            cu(rng.integers(12, 600, C)), hops[0], hops[1],
            hops[2] if has_sync else None,
            torch.tensor(1, dtype=torch.int32, device=dev),
            torch.tensor(1, dtype=torch.int32, device=dev),
        ], {"has_sync": has_sync})
    emit({"phase": "kernels", "inputs": "random", "shapes": {
        "C": C, "W1": W1, "S1": S1, "W2": W2, "NW": NW, "MW": MW, "DW": DW,
        "rl": rl, "router_hops": H3, "router_legs": [2, 3]}, "max_abs_err": max_err})

    # ---- 4. rung 1: card == CPU == JAX fixture
    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures",
                           "rung1_fft_small.json")) as f:
        fx = json.load(f)
    with open(os.path.join(ROOT, fx["config"])) as f:
        r1cfg = MachineConfig.from_json(f.read())
    r1tr = synth.GENERATORS[fx["trace"]["generator"]](**fx["trace"]["args"])
    runs = {}
    for d in ("cuda", "cpu"):
        e = Engine(r1cfg, r1tr, chunk_steps=fx["chunk_steps"], device=d)
        if d == "cuda":
            reset_launches()
            e.run()
            r1_launches = dict(build.LAUNCHES)
        else:
            e.run()
        runs[d] = e
    gpu, cpu = runs["cuda"], runs["cpu"]
    for k, n in r1_launches.items():
        if n != (gpu.steps_run if k in STEP_KERNELS else 0):
            fail(f"rung1: {k} launched {n} times in {gpu.steps_run} steps")
    gs = same_run("rung1", gpu, cpu)
    gpu.verify_invariants()

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a, np.int32).tobytes()).hexdigest()

    gc = gpu.counters
    if [int(x) for x in gpu.cycles] != fx["cycles"]:
        fail("rung1: cycles differ from the JAX fixture")
    for k, v in fx["counters"].items():
        if [int(x) for x in gc[k]] != v or [int(x) for x in cpu.counters[k]] != v:
            fail(f"rung1: counter {k} differs from the JAX fixture")
    if digest(gs["l1"]) != fx["l1_sha256"] or digest(gs["dirm"]) != fx["dirm_sha256"]:
        fail("rung1: final l1/dirm differ from the JAX fixture")
    emit({"phase": "rung1", "steps": gpu.steps_run, "launches": r1_launches,
          "card_equals_cpu": True, "equals_jax_fixture": True,
          "instructions": int(gc["instructions"].sum())})
    del runs, gpu, cpu

    # ---- 5. capture: the first chunk of each main path, card == CPU, and
    # the kernel inputs it stages
    staged = {k: {} for k in wrappers}

    def recorder(name, steps):
        real = wrappers[name]
        calls = [0]

        def rec(*args, **kw):
            if calls[0] in steps:
                a = args[1:] if name in STEP_KERNELS else args
                staged[name][calls[0]] = (
                    [x.clone() if torch.is_tensor(x) else x for x in a], kw)
            calls[0] += 1
            return real(*args, **kw)
        return rec

    check_s = {}
    for path, pcfg, ptr, names in (("headline", cfg, trace, STEP_KERNELS),
                                   ("rung3", cfg3, trace3, RUNG3_STAGED)):
        for k in names:
            setattr(mods[k], k, recorder(k, CAPTURE[path]))
        try:
            gpu = Engine(pcfg, ptr, chunk_steps=CHECK_STEPS, device=dev)
            gpu.run_steps(CHECK_STEPS)
        finally:
            for k in names:
                setattr(mods[k], k, wrappers[k])
        t0 = time.perf_counter()
        cpu = Engine(pcfg, ptr, chunk_steps=CHECK_STEPS, device="cpu")
        cpu.run_steps(CHECK_STEPS)
        check_s[path] = time.perf_counter() - t0
        same_run(f"capture {path}", gpu, cpu)
        del gpu, cpu
        for k in names:
            if set(staged[k]) != set(CAPTURE[path]):
                fail(f"capture: {k} staged inputs of steps {sorted(staged[k])} only")
            for args, kw in staged[k].values():
                compare(k, args, kw)

    def as_i32(args):
        """Bool lanes as int32, so that the step kernels' wrappers cast
        nothing (router_cascade reads its bool mask as it is)."""
        return [a.to(torch.int32) if torch.is_tensor(a) and a.dtype != torch.int32
                else a for a in args]

    timed_step = {k: CAPTURE["rung3" if k in RUNG3_STAGED else "headline"][-1]
                  for k in wrappers}
    captured = {}
    for k in wrappers:
        args, kw = staged[k][timed_step[k]]
        captured[k] = (as_i32(args) if k in STEP_KERNELS else args, kw)
        compare(k, *captured[k])

    def device_ms(fn, sleep_cycles):
        """Median device time of fn() over 25 launches, each queued behind
        a device sleep so the host's enqueue is hidden."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(25):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep_cycles)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    timing = {}
    for k in wrappers:
        args, kw = captured[k]
        timing[k] = {
            "ms": device_ms(lambda: call(wrappers[k], k, args, kw), 4_000_000),
            "plain_ms": device_ms(lambda: call(plains[k], k, args, kw), 100_000_000),
        }

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))

    # the bytes each function needs on this step's inputs, as the main path
    # stages them: every word it reads, once, and every output word, once
    a = staged["probe_classify"][300][0]  # l1 vrows mrows line cid step hm wm cm
    probe_bytes = (4 * C * (4 * W1  # tag, state, LRU, pointer: the accessed set's ways
                            + 3 * W1  # tag, owner, own sharer word at each way's pointer
                            + 2 * W2 + 2  # home row: its tags and LRUs, two owners
                            + 2 * NW)  # the hit and victim ways' sharer words
                   + nbytes(*a[3:])  # line, cid, step, run patch
                   + 4 * C * (3 * W1 + 2 * NW + step_kernels.PROBE_LANES))  # out
    a = staged["commit_step"][300][0]  # l1 mrows tag_rows shw lanes cid step counters delta hm wm cm
    win = a[4][:, step_kernels.CL_WINNER] != 0
    n_win = int(win.sum())
    n_join = int(((a[4][:, step_kernels.CL_JOIN] != 0) & ~win).sum())
    commit_bytes = (2 * nbytes(a[0])  # the L1 in and the new L1 out (whole, as defined)
                    + 4 * n_win * (4 + NW)  # a winner's changed way: pair, LRU, epoch, sharers
                    + 4 * n_join * 2  # a joiner's LRU and epoch
                    + 4 * (n_win + n_join) * NW  # their shw
                    + nbytes(a[2], *a[4:])  # tag rows, lanes, cid, step, counters, delta, patch
                    + 4 * C * DW + nbytes(a[7]))  # delta_row and counters out
    a = staged["sharer_reductions"][300][0]  # shw vic_shw btile vic_owner inv_row vic_valid cid link router
    irow, vv = a[4] != 0, a[5] != 0
    n_inv, n_vic = int(irow.sum()), int(vv.sum())
    active_rows = int((irow | vv).sum())
    red_bytes = (nbytes(a[4], a[5], a[7], a[8])  # both flags of every row, two latencies
                 + 4 * 3 * active_rows  # btile, vic_owner, cid of the active rows
                 + 4 * NW * (n_inv + n_vic)  # the sharer words those rows expand
                 + 4 * 5 * C)  # the five outputs
    red_ops = active_rows * min(32 * NW, C) * 30  # ~30 integer ops per target
    a, kw = staged["router_cascade"][CAPTURE["rung3"][-1]]  # lf bs r ok t0 service hops x3 link router
    legs = 3 if kw["has_sync"] else 2
    n_ok = int(a[3].sum())
    cas_bytes = (a[3].numel()  # every hop's mask byte
                 + 4 * 3 * n_ok  # link clock, base and rank of the live hops
                 + 4 * C * (2 + legs) + 8  # t0, service, each leg's hops, two latencies
                 + 4 * C * (legs - 1)  # the reply (and arrival) leg's end out
                 + 4 * n_ok)  # the live hops' departures (masked ones are dropped)
    cas_ops = a[3].numel() * 11  # floor 4, offset 2, running max 1, departure 4 per hop
    bounds = {
        "probe_classify": (probe_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        "commit_step": (commit_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        "sharer_reductions": max(
            (red_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            (red_ops / INT_OPS_PER_S * 1e3, "operations"),
        ),
        "router_cascade": max(
            (cas_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            (cas_ops / INT_OPS_PER_S * 1e3, "operations"),
        ),
    }
    emit({"phase": "capture", "steps": CAPTURE, "timed_step": timed_step,
          "card_equals_cpu_steps": CHECK_STEPS, "cpu_s": check_s,
          "max_abs_err": max_err, "timing_ms": timing,
          "bytes": {"probe_classify": probe_bytes, "commit_step": commit_bytes,
                    "sharer_reductions": red_bytes, "router_cascade": cas_bytes},
          "commit_winners": n_win, "commit_joiners": n_join,
          "sharer_rows": {"active": active_rows, "invalidating": n_inv,
                          "evicting": n_vic},
          "router_hops": {"legs": legs, "live": n_ok, "all": a[3].numel()},
          "gpu": smi_line})

    # ---- 6./7. the main paths, each with the counts set to 0 just before
    launches = {}
    for path, pcfg, fx, ran in (("headline", cfg, hfx, STEP_KERNELS),
                                ("rung3", cfg3, r3fx, tuple(wrappers))):
        eng = Engine(pcfg, trace, chunk_steps=fx["chunk_steps"], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        got = run_digest(eng.steps_run, eng.cycles, eng.counters,
                         eng.state.link_free.cpu().numpy(),
                         eng.state.dram_free.cpu().numpy())
        ins = got["instructions"]
        sums = got["counter_sums"]
        emit({"phase": path, "steps": eng.steps_run, "wall_s": wall,
              "simulated_mips": ins / wall / 1e6, "peak_memory_bytes": peak,
              "launches": launches[path], "instructions": ins,
              "max_core_cycles": got["max_core_cycles"],
              "noc_msgs": sums["noc_msgs"],
              "noc_contention_cycles": sums["noc_contention_cycles"],
              "dram_queue_cycles": sums["dram_queue_cycles"],
              "digest": {k: v for k, v in got.items() if k.endswith("sha256")},
              "equals_jax_digest": got == fx["digest"], "gpu": smi_line})
        for k, n in launches[path].items():
            if n != (eng.steps_run if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {eng.steps_run} steps")
        if ins != trace.total_instructions():
            fail(f"{path}: {ins} instructions retired, trace has {trace.total_instructions()}")
        for k, want in fx["digest"].items():
            if got[k] != want:
                fail(f"{path}: {k} {got[k]} != the JAX package's {want}")
        if not eng.done():
            fail(f"{path}: not every core reached END")
        eng.verify_invariants()
        del eng

    # ---- 8. profile: where the time of one chunk of each path goes
    def device_events(fn):
        """(device events of fn() as sorted (start, end, name), fn's wall
        seconds) under torch.profiler. A random fill, which the simulator
        never makes, marks where fn begins: the trace may still hold
        kernels that ran before the profile did."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)  # let the tracer settle before the marker
            torch.randn(1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        evs = list(prof.events())
        begin = min(e.time_range.start for e in evs
                    if e.device_type == DeviceType.CPU and e.name == "aten::randn")
        dev_ev = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in evs
            if e.device_type == DeviceType.CUDA and e.time_range.start >= begin
        )
        if dev_ev and "normal" in dev_ev[0][2]:
            dev_ev = dev_ev[1:]  # the marker's own kernel
        return dev_ev, wall_s

    # first what phase 5 timed: one wrapper call per kernel on the
    # converted inputs, each of which must run its kernel and nothing else
    def alone():
        for k in wrappers:
            call(wrappers[k], k, *captured[k])
            torch.cuda.synchronize()

    timed = [n for _, _, n in device_events(alone)[0]]
    if len(timed) != len(wrappers) or not all(
            f"{k}_kernel" in n for k, n in zip(wrappers, timed)):
        fail(f"profile: the timed calls ran {[n[:80] for n in timed[:8]]}, "
             "not each kernel alone")
    kernel_us = {}
    for path, pcfg, ran in (("headline", cfg, STEP_KERNELS),
                            ("rung3", cfg3, tuple(wrappers))):
        prof_eng = Engine(pcfg, trace, chunk_steps=64, device=dev)
        prof_eng.run_steps(256)  # mid-run state, as the main path meets it
        torch.cuda.synchronize()
        dev_ev, window_s = device_events(lambda: prof_eng.run_steps(64))
        del prof_eng
        busy_us, end = 0.0, None
        for a0, b0, _ in dev_ev:  # union of device intervals
            if end is None or a0 > end:
                busy_us += b0 - a0
                end = b0
            elif b0 > end:
                busy_us += b0 - end
                end = b0
        by_name: dict[str, list] = {}
        for a0, b0, n in dev_ev:
            t = by_name.setdefault(n, [0.0, 0])
            t[0] += b0 - a0
            t[1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        kernel_us[path] = {}
        for k in ran:
            hits = [tc for n, tc in by_name.items() if f"{k}_kernel" in n]
            if len(hits) != 1 or hits[0][1] != 64:
                fail(f"profile {path}: {k}'s kernel shows as {hits} in 64 steps")
            kernel_us[path][k] = hits[0][0] / hits[0][1]
        emit({"phase": "profile", "path": path, "steps": 64, "window_s": window_s,
              "device_events": len(dev_ev),
              "device_events_per_step": len(dev_ev) / 64,
              "device_busy_us": busy_us,
              "device_busy_share_of_window": (busy_us * 1e-6 / window_s) if dev_ev else None,
              "top_device_us": [[n[:80], t, c] for n, (t, c) in top],
              "kernel_us_per_launch": kernel_us[path],
              "gpu": smi_line})

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1],
         "launches": launches["rung3" if k in RUNG3_STAGED else "headline"][k],
         "launches_by_path": {p: launches[p][k] for p in launches},
         "max_abs_err": max_err[k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": None}
        for k in wrappers
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
