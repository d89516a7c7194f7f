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
                words using bit 31 (the probe and the commit on the
                full-size directory, zero but for 8192 random rows, the
                last among them, that the pointers and home slots name;
                the commit on the probe's outputs, winners and joiners
                sharing rows); sharer_reductions also at 40 cores on 16
                tiles (padding bits, victim owners among them) and at
                1100 cores (35 words: more than a warp's lanes);
                router_cascade at rung 3's shapes (1024 cores, 62 hops,
                4096 links) with and without the barrier-arrival leg, and
                at 64 cores with 2, 126 and 254 hops (1, 4 and 8 chunks of
                32 lanes): -1-padded routes of random lengths, lanes masked per
                leg (so masked hops with pth >= 0), a third of the hops on
                eight hot links, link clocks and bases near the rebase
                clamp and near INT32_MAX; its end times and link_free_out
                are compared. commit_step updates l1, dirm and counters in
                place and router_cascade its link_free_out: each of their
                calls here and below gets fresh clones of them.
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
                is then timed alone on the later step's inputs, as the
                engine passes them (every wrapper launches its kernel and
                nothing else), with CUDA events: median of 25 after
                warm-up, each launch queued behind a device sleep so host
                overhead does not count, and what the kernels update in
                place (commit_step's L1, counters and the directory rows
                its lanes name; router_cascade's link_free_out) restored
                from the staged inputs before each launch, outside the
                timed window. The
                event method's own floor is the same median for a
                torch.cuda._sleep(0) launch. Bounds are computed from the
                staged inputs. The phase's line is printed in phase 8, with
                the profiler's times of the same calls, the router's live
                hops per leg and the sharer rows' set bits.
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
                state must pass the machine invariants. Peak device
                memory is the engine's own, its state included: above what
                the process held before the engine was made.
7. rung3     -- the second main path: the shipped
                configs/rung3_1024core_o3.json (router NoC, DRAM queue, O3)
                on the same trace, likewise: all four kernels once per
                step, instructions, the digest against
                fixtures/rung3_headline.json, invariants.
8. profile   -- first, in the process's first torch.profiler session (no
                session precedes the main paths' timing), 10 wrapper calls
                per kernel on the inputs phase 5 timed, each on fresh
                copies made beforehand, each of which must run its kernel
                and nothing else: the median device time per launch joins
                the capture line, printed now. Then one 64-step chunk of
                each main path from a mid-run state
                (steps 256-319) under torch.profiler: device busy time,
                device events per step, the device time by kernel name, by
                torch operator and input shapes (which call site launched
                it), and each
                hand-written kernel's mean device time per launch (the
                profiler adds host overhead, so the window is not a speed
                figure).

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
# argument positions of what a kernel updates in place: commit_step's l1,
# dirm and counters, router_cascade's link_free_out
INPLACE = {"commit_step": (0, 1, 9), "router_cascade": (12,)}
RUNG3_STAGED = ("router_cascade",)  # staged from rung 3, the rest from the headline
CHECK_STEPS = 512  # steps of each main path that the CPU run repeats
PROF_REPS = 10  # profiled launches of each kernel alone
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

    def call(fn, name, args, kw=None, mcfg=None):
        """A wrapper or plain version on staged arguments (the step
        kernels take a machine's config first, the headline's unless
        `mcfg` names another)."""
        if name in STEP_KERNELS:
            return fn(mcfg or cfg, *args, **(kw or {}))
        return fn(*args, **(kw or {}))

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

    def fresh(name, args):
        """Clones of the arguments a kernel updates in place (a kernel
        relaunched on one set of inputs would see its own writes)."""
        return [a.clone() if i in INPLACE.get(name, ()) else a
                for i, a in enumerate(args)]

    def outputs(fn, name, args, kw=None, mcfg=None):
        """fn on fresh clones: what it returns, then the tensors it
        updates in place."""
        a = fresh(name, args)
        out = call(fn, name, a, kw, mcfg)
        return list(out or ()) + [a[i] for i in INPLACE.get(name, ())]

    def compare(name, args, kw=None, mcfg=None):
        """The kernel (through its wrapper) against the plain version on
        the same card tensors; returns the kernel's outputs."""
        got = outputs(wrappers[name], name, args, kw, mcfg)
        want = outputs(plains[name], name, args, kw, mcfg)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                fail(f"{name}: the kernel and its plain version return different outputs")
            if g is not None and not torch.equal(g, w):
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

    # the full-size directory, zero but for a pool of random rows (the
    # last row among them) that the pointers and home slots name; the
    # home slots come from 256 of them, so rows are shared
    n_lines = 6
    pool = np.append(rng.choice(NS - 1, 8191, replace=False), NS - 1)
    prow = rng.integers(0, len(pool), (C, W1))
    ptr = pool[prow] * W2 + rng.integers(0, W2, (C, W1))
    slot = pool[rng.integers(len(pool) - 256, len(pool), C)]
    line = rng.integers(0, n_lines, C)
    cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
    l1 = np.concatenate([
        rng.integers(-1, n_lines, (C, FS)), rng.integers(0, 4, (C, FS)),
        rng.integers(0, 4, (C, FS)), rng.integers(0, NS * W2, (C, FS)),
        rng.integers(0, 3, (C, FS)),
    ], axis=1)
    l1[np.arange(C)[:, None], 3 * FS + cols] = ptr
    rows = dir_rows(len(pool), n_lines)
    at = {r: i for i, r in enumerate(pool)}
    cc, ww = np.nonzero(rng.random((C, W1)) < 0.5)  # live copies, a third owned
    for c, w in zip(cc, ww):
        i, pway = at[ptr[c, w] // W2], ptr[c, w] % W2
        rows[i, 2 * pway] = l1[c, cols[c, w]]
        if rng.random() < 0.3:
            rows[i, 2 * pway + 1] = c
    dirm = torch.zeros(NS, DW, dtype=torch.int32, device=dev)
    dirm[torch.from_numpy(pool).to(dev)] = cu(rows)
    run_cols = np.where(rng.random((C, rl)) < 0.5,
                        rng.integers(0, W1, (C, rl)) * S1 + (line & (S1 - 1))[:, None],
                        rng.integers(0, FS, (C, rl)))
    patch = [torch.from_numpy(rng.random((C, rl)) < 0.5).to(dev),
             torch.from_numpy(rng.random((C, rl)) < 0.5).to(dev), cu(run_cols)]
    cid = cu(np.arange(C))
    step_no = torch.tensor(777, dtype=torch.int32, device=dev)
    pc_out = compare("probe_classify", [
        cu(l1), dirm, cu(slot), cu(line), cid, step_no, *patch,
    ])
    pc_lanes = pc_out[5].cpu().numpy()
    flags = rng.integers(0, 2, (C, 18))
    lanes = np.stack([
        line, rng.integers(0, W1, C), rng.integers(0, W1, C), *flags[:, 3:9].T,
        rng.integers(0, 4, C), slot, pc_lanes[:, step_kernels.PL_LLC_HWAY],
        pc_lanes[:, step_kernels.PL_LLC_VWAY], *flags[:, 13:17].T,
        rng.integers(0, C, C),
    ], axis=1)
    compare("commit_step", [
        cu(rng.integers(-5, 50, (C, 5 * FS))), dirm, pc_out[0], pc_out[3],
        pc_out[4], cu(lanes), pc_out[5], cid, step_no,
        cu(rng.integers(-(2**31), 2**31, (26, C), dtype=np.int64)),
        cu(rng.integers(0, 2**30, (26, C))), *patch,
    ])
    del dirm
    def sharer_args(mcfg):
        n = mcfg.n_cores
        return [
            cu(words((n, mcfg.n_sharer_words))), cu(words((n, mcfg.n_sharer_words))),
            cu(rng.integers(0, mcfg.n_tiles, n)), cu(rng.integers(-1, 32 * mcfg.n_sharer_words, n)),
            torch.from_numpy(rng.random(n) < 0.5).to(dev),
            torch.from_numpy(rng.random(n) < 0.5).to(dev), cu(np.arange(n)),
            torch.tensor(1, dtype=torch.int32, device=dev),
            torch.tensor(1, dtype=torch.int32, device=dev),
        ]

    # the headline's 32 words, then padding bits (40 cores on 16 tiles)
    # and more words than lanes (1100 cores: 35 words)
    compare("sharer_reductions", sharer_args(cfg))
    spec = json.loads(cfg.to_json())
    for n, mx, my in ((40, 4, 4), (1100, 44, 25)):
        mcfg = MachineConfig.from_dict({**spec, "n_cores": n, "noc": {
            **spec["noc"], "mesh_x": mx, "mesh_y": my}})
        compare("sharer_reductions", sharer_args(mcfg), mcfg=mcfg)

    def router_args(n, H, NL, has_sync):
        """Random routes of random lengths, -1-padded; lanes masked per
        leg (so masked hops with pth >= 0); a third of the hops on eight
        hot links; link clocks and bases live, near the rebase clamp and
        near INT32_MAX."""
        legs = 3 if has_sync else 2
        hot = rng.choice(NL, 8, replace=False)

        def clocks(empty):
            u = rng.random(NL)
            return np.where(u < 0.2, -(1 << 30) + rng.integers(0, 50, NL),
                            np.where(u < 0.2 + empty, 2**31 - 1 - rng.integers(0, 50, NL),
                                     rng.integers(-2000, 900_000, NL)))

        hops = rng.integers(0, H + 1, (n, legs))  # each leg's route length
        pth = np.where(rng.random((n, legs, H)) < 1 / 3,
                       hot[rng.integers(0, 8, (n, legs, H))],
                       rng.integers(0, NL, (n, legs, H)))
        pth = np.where(np.arange(H) < hops[:, :, None], pth, -1).reshape(n, legs * H)
        ok = np.repeat(rng.random((n, legs)) < 0.5, H, axis=1) & (pth >= 0)
        return [
            cu(clocks(0.05)), cu(clocks(0.3)), cu(pth), torch.from_numpy(ok).to(dev),
            cu(rng.integers(0, 60, (n, legs * H))), cu(rng.integers(0, 900_000, n)),
            cu(rng.integers(12, 600, n)), cu(hops[:, 0]), cu(hops[:, 1]),
            cu(hops[:, 2]) if has_sync else None,
            torch.tensor(1, dtype=torch.int32, device=dev),
            torch.tensor(1, dtype=torch.int32, device=dev),
            cu(clocks(0.05)),  # link_free_out: another copy's clocks
        ]

    # rung 3's shapes, then routes of 1, 4 and 8 chunks of 32 hops
    for n, H, NL, has_sync in ((C, H3, 4 * cfg3.n_tiles, False),
                               (C, H3, 4 * cfg3.n_tiles, True),
                               (64, 2, 16, True), (64, 126, 16384, False),
                               (64, 254, 65536, True)):
        compare("router_cascade", router_args(n, H, NL, has_sync), {"has_sync": has_sync})
    emit({"phase": "kernels", "inputs": "random", "shapes": {
        "C": C, "W1": W1, "S1": S1, "W2": W2, "NW": NW, "MW": MW, "DW": DW,
        "rl": rl, "router_hops": [2, H3, 126, 254], "router_legs": [2, 3],
        "sharer_cores": [C, 40, 1100]}, "max_abs_err": max_err})

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

    timed_step = {k: CAPTURE["rung3" if k in RUNG3_STAGED else "headline"][-1]
                  for k in wrappers}

    captured = {k: staged[k][timed_step[k]] for k in wrappers}

    def timed_call(k):
        """(launch, prep): one wrapper call on the timed step's inputs, and
        what restores the tensors it updates in place beforehand (outside
        the timed window). commit_step changes only the directory rows its
        lanes name (column CL_SLOT), so only those rows are restored: a
        copy of the whole directory would leave L2 full of dirty lines."""
        args, kw = captured[k]
        work = fresh(k, args)
        pairs = []
        for i in INPLACE.get(k, ()):
            rows = (torch.unique(args[5][:, step_kernels.CL_SLOT]).long()
                    if (k, i) == ("commit_step", 1) else None)
            pairs.append((work[i], rows, args[i] if rows is None else args[i][rows]))

        def prep():
            for w, rows, src in pairs:
                if rows is None:
                    w.copy_(src)
                else:
                    w.index_copy_(0, rows, src)
        return (lambda fn: call(fn, k, work, kw)), prep

    def device_ms(fn, sleep_cycles, prep=lambda: None):
        """Median device time of fn() over 25 launches, each queued behind
        a device sleep so the host's enqueue is hidden."""
        for _ in range(3):
            prep()
            fn()
        times = []
        for _ in range(25):
            prep()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep_cycles)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    def device_events(fn, by_op=False):
        """(device events of fn() as sorted (start, end, name), fn's wall
        seconds, and with `by_op` the 16 torch operators, by input shapes,
        whose own kernels took the most device time) under
        torch.profiler. A random fill, which the simulator never makes,
        marks where fn begins: the trace may still hold kernels that ran
        before the profile did."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=by_op) as prof:
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
        ops = sorted(
            ([e.key, str(e.input_shapes)[:100], e.self_device_time_total, e.count]
             for e in prof.key_averages(group_by_input_shape=True)
             if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
            key=lambda o: -o[2])[:16] if by_op else None
        return dev_ev, wall_s, ops

    timing = {}
    for k in wrappers:
        launch, prep = timed_call(k)
        timing[k] = {
            "ms": device_ms(lambda: launch(wrappers[k]), 4_000_000, prep),
            "plain_ms": device_ms(lambda: launch(plains[k]), 100_000_000, prep),
        }
    event_floor_ms = device_ms(lambda: torch.cuda._sleep(0), 4_000_000)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))

    # the bytes each function needs on this step's inputs, as the main path
    # stages them: every word it reads, once, and every output word, once
    a = staged["probe_classify"][300][0]  # l1 dirm slot line cid step hm wm cm
    probe_bytes = (4 * C * (4 * W1  # tag, state, LRU, pointer: the accessed set's ways
                            + 3 * W1  # tag, owner, own sharer word at each way's pointer
                            + 2 * W2 + 4  # home row: tags, LRUs, two owners, two epochs
                            + 2 * NW)  # the hit and victim ways' sharer words
                   + nbytes(*a[2:])  # slot, line, cid, step, run patch
                   + 4 * C * (3 * W1 + 2 * NW + step_kernels.PROBE_LANES))  # out
    # commit_step, in place: the L1 and directory words it changes (the
    # old directory words come from the probe's lanes), the counters in
    # and out with the delta, the lanes and the probe outputs it reads
    a = staged["commit_step"][300][0]  # l1 dirm tag shw vic_shw lanes pc cid step counters delta hm wm cm
    new_l1, new_dirm, _ = outputs(wrappers["commit_step"], "commit_step", a)
    l1_words = int((new_l1 != a[0]).sum())
    dirm_words = int((new_dirm != a[1]).sum())
    del new_l1, new_dirm
    win = a[5][:, step_kernels.CL_WINNER] != 0
    n_win = int(win.sum())
    n_join = int(((a[5][:, step_kernels.CL_JOIN] != 0) & ~win).sum())
    commit_bytes = (4 * (l1_words + dirm_words)
                    + 3 * nbytes(a[9])  # counters in and out, delta in
                    + nbytes(a[2], a[5], *a[7:9], *a[11:])  # tag rows, lanes, cid, step, patch
                    + 4 * C * 8  # the home-row words of the probe's lanes
                    + 4 * (n_win * NW + n_join))  # old sharer words, a joiner's own word
    a = staged["sharer_reductions"][300][0]  # shw vic_shw btile vic_owner inv_row vic_valid cid link router
    irow, vv = a[4], a[5]  # bool
    n_inv, n_vic = int(irow.sum()), int(vv.sum())
    active_rows = int((irow | vv).sum())
    red_out = outputs(plains["sharer_reductions"], "sharer_reductions", a)
    inv_bits, back_bits = int(red_out[1].sum()), int(red_out[3].sum())  # set bits walked
    red_bytes = (nbytes(a[4], a[5], a[7], a[8])  # both flag bytes of every row, two latencies
                 + 4 * 3 * active_rows  # btile, vic_owner, cid of the active rows
                 + 4 * NW * (n_inv + n_vic)  # the sharer words of those rows
                 + 4 * 5 * C)  # the five outputs
    # per word read: mask, popcount, sum; per set bit: find and clear it,
    # the target's tile, its hop count and the hop sum, and for the
    # invalidation set the latency and its max
    red_ops = 5 * NW * (n_inv + n_vic) + 16 * inv_bits + 12 * back_bits
    a, kw = staged["router_cascade"][CAPTURE["rung3"][-1]]  # lf base pth ok r t0 service hops x3 link router out
    legs = 3 if kw["has_sync"] else 2
    n_ok = int(a[3].sum())
    live_by_leg = [int(x) for x in a[3].view(C, legs, -1).sum((0, 2))]
    cas_bytes = (a[3].numel()  # every hop's mask byte
                 + 4 * 4 * n_ok  # route, link clock, base and rank of the live hops
                 + 8 * n_ok  # read-modify-write of each live hop's departure
                 + 4 * C * (2 + legs) + 8  # t0, service, each leg's hops, two latencies
                 + 4 * C * (legs - 1))  # the reply (and arrival) leg's end out
    # floor 4, offset 2, running max 1, departure 4 per live hop; the
    # masked hops' SENT offsets and running max, 2 each
    cas_ops = 11 * n_ok + 2 * (a[3].numel() - n_ok)
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
    capture_line = {"phase": "capture", "steps": CAPTURE, "timed_step": timed_step,
          "card_equals_cpu_steps": CHECK_STEPS, "cpu_s": check_s,
          "max_abs_err": max_err, "timing_ms": timing,
          "event_floor_ms": event_floor_ms, "profiler_reps": PROF_REPS,
          "bytes": {"probe_classify": probe_bytes, "commit_step": commit_bytes,
                    "sharer_reductions": red_bytes, "router_cascade": cas_bytes},
          "commit_winners": n_win, "commit_joiners": n_join,
          "commit_words_changed": {"l1": l1_words, "dirm": dirm_words},
          "sharer_rows": {"active": active_rows, "invalidating": n_inv,
                          "evicting": n_vic, "invalidation_bits": inv_bits,
                          "back_invalidation_bits": back_bits},
          "router_hops": {"legs": legs, "live": n_ok, "live_by_leg": live_by_leg,
                          "all": a[3].numel()},
          "gpu": smi_line}
    del staged  # the other staged steps, before the main paths' peaks

    # ---- 6./7. the main paths, each with the counts set to 0 just before
    launches = {}
    for path, pcfg, fx, ran in (("headline", cfg, hfx, STEP_KERNELS),
                                ("rung3", cfg3, r3fx, tuple(wrappers))):
        held = torch.cuda.memory_allocated()  # the timed step's inputs, kept for phase 8
        eng = Engine(pcfg, trace, chunk_steps=fx["chunk_steps"], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
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

    # ---- 8. profile. First the profiler's device time per launch of the
    # calls phase 5 timed, in the process's first profiler session (none
    # precedes the main paths' timing), each on inputs of its own (fresh
    # copies made beforehand): each call must run its kernel and nothing
    # else. Then where the time of one chunk of each path goes.
    reps = {k: [fresh(k, captured[k][0]) for _ in range(PROF_REPS)] for k in wrappers}

    def alone():
        for k in wrappers:
            for a in reps[k]:
                call(wrappers[k], k, a, captured[k][1])
                torch.cuda.synchronize()

    timed = device_events(alone)[0]
    del reps
    want = [k for k in wrappers for _ in range(PROF_REPS)]
    if len(timed) != len(want) or not all(
            f"{k}_kernel" in n for k, (_, _, n) in zip(want, timed)):
        ran = [[n[:60], 1] for _, _, n in timed[:1]]
        for _, _, n in timed[1:]:  # runs of one name
            if n[:60] == ran[-1][0]:
                ran[-1][1] += 1
            else:
                ran.append([n[:60], 1])
        fail(f"capture: {len(timed)} device events for {len(want)} timed calls "
             f"({PROF_REPS} per kernel), in runs {ran}: not each kernel alone")
    for i, k in enumerate(wrappers):
        us = [b0 - a0 for a0, b0, _ in timed[i * PROF_REPS:(i + 1) * PROF_REPS]]
        timing[k]["profiler_us"] = float(np.median(us))
    emit(capture_line)
    del captured

    kernel_us = {}
    for path, pcfg, ran in (("headline", cfg, STEP_KERNELS),
                            ("rung3", cfg3, tuple(wrappers))):
        prof_eng = Engine(pcfg, trace, chunk_steps=64, device=dev)
        prof_eng.run_steps(256)  # mid-run state, as the main path meets it
        torch.cuda.synchronize()
        dev_ev, window_s, top_ops = device_events(lambda: prof_eng.run_steps(64), by_op=True)
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
              "top_ops_device_us": top_ops,
              "kernel_us_per_launch": kernel_us[path],
              "gpu": smi_line})

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1],
         "launches": launches["rung3" if k in RUNG3_STAGED else "headline"][k],
         "launches_by_path": {p: launches[p][k] for p in launches},
         "max_abs_err": max_err[k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"],
         "profiler_us_per_launch": timing[k]["profiler_us"],
         "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": None}
        for k in wrappers
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
