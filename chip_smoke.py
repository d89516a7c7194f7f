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
                exactly (integer simulator: tolerance 0), on random inputs
                at the headline shapes with sharer words using bit 31.
4. rung1     -- configs/rung1_64core_fft.json on fft_like(64, n_phases=2,
                points_per_core=32, seed=7), a trace with barriers: the
                card's run launches every kernel once per step, equals
                the port's CPU run in every state field and equals the
                committed JAX reference fixture.
5. capture   -- the kernel inputs that the headline run stages at steps 1
                and 300; each kernel against its plain version on them.
                Each kernel is then timed alone on
                step 300's inputs (converted beforehand, so that the
                wrapper launches the one kernel and nothing else, which
                phase 7 confirms) with CUDA events: median of 25 after
                warm-up, each launch queued behind a device sleep so host
                overhead does not count.
6. headline  -- the main path: 1024 cores / 1024 banks, 32x32 mesh, the
                folded fft_like(1024, 4 phases, 256 points, seed 42) trace,
                chunk_steps=512, run to completion through Engine.run with
                the launch counters set to 0 just before. Every kernel must
                have launched once per step, the instruction count must
                equal the trace's, the results must equal the JAX
                package's recorded headline run, and the final state must
                pass the machine invariants. The port's CPU path then runs
                the same machine and trace: the card's run must equal it
                in per-core cycles, all 26 counters and every state field.
7. profile   -- torch.profiler over one 64-step chunk of the headline run
                from a mid-run state: device busy time, device events per
                step, the device time by kernel name and each hand-written
                kernel's mean device time per launch (the profiler adds
                host overhead, so the window is not a speed figure).
                Before the window, one wrapper call per kernel on the
                inputs phase 5 timed, each of which must run its kernel
                alone.

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
# The JAX package's own run of the headline machine and trace
# (BENCH_r05.json "detail"): simulation results, not timings.
HEADLINE_REF = {"steps": 1536, "instructions": 21163720,
                "max_core_cycles": 118141, "noc_msgs": 1093900}
KERNEL_META = {
    "probe_classify": ("primesim_tpu_torch/csrc/probe_classify.cu",
                       "primesim_tpu/kernels/step_kernels.py:258"),
    "commit_step": ("primesim_tpu_torch/csrc/commit_step.cu",
                    "primesim_tpu/kernels/step_kernels.py:475"),
    "sharer_reductions": ("primesim_tpu_torch/csrc/sharer_reductions.cu",
                          "primesim_tpu/kernels/reductions.py:103"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def headline_config(MachineConfig, CacheConfig, NocConfig):
    return MachineConfig(
        n_cores=1024, n_banks=1024,
        l1=CacheConfig(size=32 * 1024, ways=4, line=64, latency=2),
        llc=CacheConfig(size=256 * 1024, ways=8, line=64, latency=10),
        noc=NocConfig(mesh_x=32, mesh_y=32, link_lat=1, router_lat=1),
        dram_lat=100, quantum=1000, local_run_len=8,
    )


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
    from primesim_tpu_torch.config.machine import CacheConfig, MachineConfig, NocConfig
    from primesim_tpu_torch.kernels import build, reductions, step_kernels
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.sim.state import dirm_width, llc_meta_width
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.trace.format import fold_ins
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    wrappers = {
        "probe_classify": step_kernels.probe_classify,
        "commit_step": step_kernels.commit_step,
        "sharer_reductions": reductions.sharer_reductions,
    }
    plains = {
        "probe_classify": step_kernels.probe_classify_plain,
        "commit_step": step_kernels.commit_step_plain,
        "sharer_reductions": reductions.sharer_reductions_plain,
    }

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

    cfg = headline_config(MachineConfig, CacheConfig, NocConfig)
    C, S1, W1 = cfg.n_cores, cfg.l1.sets, cfg.l1.ways
    W2, NW = cfg.llc.ways, cfg.n_sharer_words
    MW, DW, FS = llc_meta_width(cfg), dirm_width(cfg), W1 * S1
    NS, rl = cfg.n_banks * cfg.llc.sets, cfg.local_run_len
    max_err = {k: 0 for k in wrappers}

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

    def compare(name, args):
        """The kernel (through its wrapper) against the plain version on
        the same card tensors; returns the max absolute difference."""
        got = wrappers[name](cfg, *args)
        want = plains[name](cfg, *args)
        torch.cuda.synchronize()
        err = max(
            int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(got, want)
        )
        max_err[name] = max(max_err[name], err)
        if err != 0:
            fail(f"{name}: kernel differs from its plain version by {err}")
        return got

    # ---- 3. kernels on random inputs at the headline shapes
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
    emit({"phase": "kernels", "inputs": "random", "shapes": {
        "C": C, "W1": W1, "S1": S1, "W2": W2, "NW": NW, "MW": MW, "DW": DW,
        "rl": rl}, "max_abs_err": max_err})

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
        if n != gpu.steps_run:
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

    # ---- 5. capture: the headline run's staged kernel inputs at one step
    trace = fold_ins(synth.fft_like(C, n_phases=4, points_per_core=256,
                                    ins_per_mem=8, seed=42))
    # step 1 (cold caches) and step 300 (mid-run: shared lines, evictions);
    # the kernels are timed on step 300's inputs
    CAPTURE_STEPS = (1, 300)
    CAPTURE_STEP = CAPTURE_STEPS[-1]
    staged = {k: {} for k in wrappers}

    def recorder(name):
        real = wrappers[name]
        calls = [0]

        def rec(*args):
            if calls[0] in CAPTURE_STEPS:
                staged[name][calls[0]] = [a.clone() if torch.is_tensor(a) else a
                                          for a in args[1:]]
            calls[0] += 1
            return real(*args)
        return rec

    mods = {"probe_classify": step_kernels, "commit_step": step_kernels,
            "sharer_reductions": reductions}
    for k, m in mods.items():
        setattr(m, k, recorder(k))
    try:
        cap = Engine(cfg, trace, chunk_steps=CAPTURE_STEP + 1, device=dev)
        cap.run_steps(CAPTURE_STEP + 1)
    finally:
        for k, m in mods.items():
            setattr(m, k, wrappers[k])
    for k in wrappers:
        if set(staged[k]) != set(CAPTURE_STEPS):
            fail(f"capture: {k} staged inputs of steps {sorted(staged[k])} only")
        for args in staged[k].values():
            compare(k, args)
    del cap

    def as_i32(args):
        """Bool lanes as int32, so that the wrapper casts nothing."""
        return [a.to(torch.int32) if torch.is_tensor(a) and a.dtype != torch.int32
                else a for a in args]

    captured = {k: as_i32(staged[k][CAPTURE_STEP]) for k in wrappers}
    for k in wrappers:
        compare(k, captured[k])

    def device_ms(fn, args, sleep_cycles):
        """Median device time of fn(cfg, *args) over 25 launches, each
        queued behind a device sleep so the host's enqueue is hidden."""
        for _ in range(3):
            fn(cfg, *args)
        times = []
        for _ in range(25):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep_cycles)
            s.record()
            fn(cfg, *args)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    timing = {}
    for k in wrappers:
        timing[k] = {
            "ms": device_ms(wrappers[k], captured[k], 4_000_000),
            "plain_ms": device_ms(plains[k], captured[k], 100_000_000),
        }

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))

    # the bytes each function needs on this step's inputs, as the main path
    # stages them: every word it reads, once, and every output word, once
    a = staged["probe_classify"][CAPTURE_STEP]  # l1 vrows mrows line cid step hm wm cm
    probe_bytes = (4 * C * (4 * W1  # tag, state, LRU, pointer: the accessed set's ways
                            + 3 * W1  # tag, owner, own sharer word at each way's pointer
                            + 2 * W2 + 2  # home row: its tags and LRUs, two owners
                            + 2 * NW)  # the hit and victim ways' sharer words
                   + nbytes(*a[3:])  # line, cid, step, run patch
                   + 4 * C * (3 * W1 + 2 * NW + step_kernels.PROBE_LANES))  # out
    a = staged["commit_step"][CAPTURE_STEP]  # l1 mrows tag_rows shw lanes cid step counters delta hm wm cm
    win = a[4][:, step_kernels.CL_WINNER] != 0
    n_win = int(win.sum())
    n_join = int(((a[4][:, step_kernels.CL_JOIN] != 0) & ~win).sum())
    commit_bytes = (2 * nbytes(a[0])  # the L1 in and the new L1 out (whole, as defined)
                    + 4 * n_win * (4 + NW)  # a winner's changed way: pair, LRU, epoch, sharers
                    + 4 * n_join * 2  # a joiner's LRU and epoch
                    + 4 * (n_win + n_join) * NW  # their shw
                    + nbytes(a[2], *a[4:])  # tag rows, lanes, cid, step, counters, delta, patch
                    + 4 * C * DW + nbytes(a[7]))  # delta_row and counters out
    a = staged["sharer_reductions"][CAPTURE_STEP]  # shw vic_shw btile vic_owner inv_row vic_valid cid link router
    irow, vv = a[4] != 0, a[5] != 0
    n_inv, n_vic = int(irow.sum()), int(vv.sum())
    active_rows = int((irow | vv).sum())
    red_bytes = (nbytes(a[4], a[5], a[7], a[8])  # both flags of every row, two latencies
                 + 4 * 3 * active_rows  # btile, vic_owner, cid of the active rows
                 + 4 * NW * (n_inv + n_vic)  # the sharer words those rows expand
                 + 4 * 5 * C)  # the five outputs
    red_ops = active_rows * min(32 * NW, C) * 30  # ~30 integer ops per target
    bounds = {
        "probe_classify": (probe_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        "commit_step": (commit_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        "sharer_reductions": max(
            (red_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            (red_ops / INT_OPS_PER_S * 1e3, "operations"),
        ),
    }
    emit({"phase": "capture", "steps": CAPTURE_STEPS, "timed_step": CAPTURE_STEP,
          "max_abs_err": max_err,
          "timing_ms": timing, "bytes": {"probe_classify": probe_bytes,
          "commit_step": commit_bytes, "sharer_reductions": red_bytes},
          "commit_winners": n_win, "commit_joiners": n_join,
          "sharer_rows": {"active": active_rows, "invalidating": n_inv,
                          "evicting": n_vic}})

    # ---- 6. headline: the main path
    eng = Engine(cfg, trace, chunk_steps=512, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cyc, cnt = eng.cycles, eng.counters
    ins = int(cnt["instructions"].sum())
    got_ref = {"steps": eng.steps_run, "instructions": ins,
               "max_core_cycles": int(cyc.max()),
               "noc_msgs": int(cnt["noc_msgs"].sum())}
    h = hashlib.sha256(cyc.astype(np.int64).tobytes())
    for k in sorted(cnt):
        h.update(cnt[k].astype(np.int64).tobytes())
    emit({"phase": "headline", "steps": eng.steps_run, "wall_s": wall,
          "simulated_mips": ins / wall / 1e6,
          "peak_memory_bytes": peak, "launches": launches,
          "cycles_counters_sha256": h.hexdigest(), "result": got_ref,
          "jax_reference": HEADLINE_REF, "gpu": smi_line})
    for k, n in launches.items():
        if n <= 0 or n != eng.steps_run:
            fail(f"headline: {k} launched {n} times in {eng.steps_run} steps")
    if ins != trace.total_instructions():
        fail(f"headline: {ins} instructions retired, trace has {trace.total_instructions()}")
    if got_ref != HEADLINE_REF:
        fail(f"headline: {got_ref} != the JAX package's {HEADLINE_REF}")
    if not eng.done():
        fail("headline: not every core reached END")
    eng.verify_invariants()
    t0 = time.perf_counter()
    ref = Engine(cfg, trace, chunk_steps=512, device="cpu")
    ref.run()
    cpu_s = time.perf_counter() - t0
    same_run("headline", eng, ref)
    emit({"phase": "headline_cpu", "steps": ref.steps_run, "wall_s": cpu_s,
          "card_equals_cpu": True})
    del ref

    # ---- 7. profile: where the time of one headline chunk goes
    del eng
    prof_eng = Engine(cfg, trace, chunk_steps=64, device=dev)
    prof_eng.run_steps(256)  # mid-run state, as the headline meets it
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # first what phase 5 timed: one wrapper call per kernel on the
        # converted inputs, then a fill that marks where they end
        for k in wrappers:
            wrappers[k](cfg, *captured[k])
            torch.cuda.synchronize()
        torch.full((1,), 7, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof_eng.run_steps(64)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev_ev = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    timed = [n for _, _, n in dev_ev[: len(wrappers) + 1]]
    marks = [f"{k}_kernel" for k in wrappers] + ["FillFunctor"]
    if len(timed) != len(marks) or not all(m in n for m, n in zip(marks, timed)):
        fail(f"profile: the timed calls ran {timed}, not each kernel alone")
    dev_ev = dev_ev[len(marks):]  # the 64-step window
    busy_us, end = 0.0, None
    for a, b, _ in dev_ev:  # union of device intervals
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    by_name: dict[str, list] = {}
    for a, b, n in dev_ev:
        t = by_name.setdefault(n, [0.0, 0])
        t[0] += b - a
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    kernel_us = {}
    for k in wrappers:
        hits = [tc for n, tc in by_name.items() if f"{k}_kernel" in n]
        if len(hits) != 1 or hits[0][1] != 64:
            fail(f"profile: {k}'s kernel shows as {hits} in 64 steps")
        kernel_us[k] = hits[0][0] / hits[0][1]
    emit({"phase": "profile", "steps": 64, "window_s": window_s,
          "device_events": len(dev_ev),
          "device_events_per_step": len(dev_ev) / 64,
          "device_busy_us": busy_us,
          "device_busy_share_of_window": (busy_us * 1e-6 / window_s) if dev_ev else None,
          "top_device_us": [[n[:80], t, c] for n, (t, c) in top],
          "kernel_us_per_launch": kernel_us,
          "gpu": smi_line})

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1], "launches": launches[k],
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
