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
                sharing rows); the probe and the commit again at rung 5's
                shapes (16384 cores, 64-core sharer groups, its 3.2 GB
                directory) with random fill-time and entry epochs, so that
                group-bit copies meet changed epochs (the phase fails if
                none does); sharer_reductions also at 40 cores on 16
                tiles (padding bits, victim owners among them), at
                1100 cores (35 words: more than a warp's lanes), at rung
                4's 4096 cores (128 words) and in its group mode at rung
                5's 16384 cores and 256 groups, with rows whose requester's
                group is flagged and rows whose victim owner lies outside
                the victim's flagged groups; the machine zoo's modes:
                commit_step under MOESI at the headline's shapes (the
                phase fails unless some GETS-probe winner's row already
                holds sharer words with bit 31), sharer_reductions in its
                torus mode at the IPU profile's shapes (1472 cores, 46
                words, 32x46 torus), its ring mode at 40 cores on a 5x3
                grid (odd sizes, padding bits) and its group mode on a
                16x16 torus (256 cores, 4-core groups);
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
   reduced   -- the two large-core directory modes at 256 cores: rung 5's
                machine with 4-core groups and rung 4's with a 2-word
                chunk, each on a folded fft_like(256, 8 phases, 16
                points) trace, run to completion on the card and on the
                CPU: equal in every field, the step kernels launched once
                per step. Likewise two 256-core zoo machines on a 16x16
                grid: a ring with the stride prefetcher on
                stream(256, 128 ops) and a torus under MOESI on
                readers_writer(256, 8 rounds).
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
   rung4     -- the shipped configs/rung4_4096core_biglittle.json (4096
                cores and banks, 64x64 mesh, chunked full map: 128 sharer
                words, a 9.66 GB directory) at full geometry on the folded
                fft_like(4096, 4 phases, 128 points, seed 42) trace,
                likewise against fixtures/rung4_full.json: the three step
                kernels once per step, router_cascade never.
   rung5     -- the shipped configs/rung5_16384core_wafer.json (16384
                cores, 128x128 mesh, 64-core sharer groups) on the folded
                fft_like(16384, 8 phases, 32 points, seed 42) trace,
                likewise against fixtures/rung5_full.json. Neither large
                path is repeated on the CPU (the reduced phase holds their
                modes there); each engine is freed before the next.
   zoo_smoke -- the machine zoo's shipped 16-core torus/MOESI/stride
                machine (configs/zoo_smoke_16core_torus_moesi.json) on
                CI's folded fft_like(16, 2 phases, 16 points, 4 INS per
                memory op, seed 42) trace, likewise against
                fixtures/zoo_smoke.json, and equal to the port's CPU run
                in every field.
   ipu       -- the shipped configs/zoo_ipu_1472tile_bsp.json (1472 cores,
                64 banks, 32x46 torus, 512 KiB L1s, quantum 50000, stride
                prefetcher) at full geometry on a folded
                barrier_phases(1472, 32 phases, 32 lines, 2 INS per
                memory op, seed 42) trace, against fixtures/ipu_full.json:
                the step kernels once per step, router_cascade never; the
                phase fails unless barrier waits and prefetch hits are
                both nonzero (the first card path with sync events).
   headline_moesi -- the headline machine under MOESI on the headline
                trace, against fixtures/headline_moesi.json; the phase
                fails if its probes equal the MESI headline's.
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
                figure). Rungs 4 and 5, the IPU profile and the MOESI
                headline get the same window; then, of the
                next 64 steps, the inputs of the step whose
                sharer_reductions has the most invalidating or evicting
                rows are staged, each kernel is held to its plain version
                on them, timed alone by CUDA events as in phase 5 and
                given a bound from them (one "mode" line per path).

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
# each kernel's launch-argument modes, every one held to its plain version
# in the kernels phase
KERNEL_MODES = {
    "probe_classify": ["full map", "coarse (logG > 0: group bits, epoch guard)"],
    "commit_step": ["MESI", "MOESI (moesi = 1)", "group words (logG > 0)"],
    "sharer_reductions": ["full map", "group (logG > 0)",
                          "mesh, torus, ring (topology = 0, 1, 2)"],
    "router_cascade": ["2 legs", "3 legs (has_sync)"],
}
# argument positions of what a kernel updates in place: commit_step's l1,
# dirm and counters, router_cascade's link_free_out
INPLACE = {"commit_step": (0, 1, 9), "router_cascade": (12,)}
RUNG3_STAGED = ("router_cascade",)  # staged from rung 3, the rest from the headline
CHECK_STEPS = 512  # steps of each main path that the CPU run repeats
PROF_REPS = 10  # profiled launches of each kernel alone
CAPTURE = {"headline": (1, 300), "rung3": (1, 500)}
# the full-geometry large-core paths and the zoo's main paths: (path,
# fixture); the profile window of each but zoo_smoke covers steps 256-319
# and their kernels are staged at the busiest of steps 320-383 (a "mode"
# line: rung 4's 128-word full map, rung 5's group mode, the IPU's torus
# mode, the headline's MOESI commit)
LARGE = (("rung4", "rung4_full"), ("rung5", "rung5_full"))
ZOO = (("zoo_smoke", "zoo_smoke"), ("ipu", "ipu_full"),
       ("headline_moesi", "headline_moesi"))
MODE_PATHS = ("rung4", "rung5", "ipu", "headline_moesi")


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
    from primesim_tpu_torch.sim.engine import Engine, group_tables
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

    t0 = time.perf_counter()
    hfx, cfg, trace = fixture("headline")
    r3fx, cfg3, trace3 = fixture("rung3_headline")
    if trace3.events.tobytes() != trace.events.tobytes():
        fail("rung 3's fixture names another trace than the headline's")
    large = {path: fixture(name) for path, name in LARGE}
    cfg4, cfg5 = large["rung4"][1], large["rung5"][1]
    zoo = {path: fixture(name) for path, name in ZOO}
    cfg_ipu, cfg_hm = zoo["ipu"][1], zoo["headline_moesi"][1]
    traces_s = time.perf_counter() - t0
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

    def step_kernels_random(mcfg):
        """probe_classify, then commit_step on its outputs, on random
        inputs at mcfg's shapes: the full-size directory, zero but for a
        pool of random rows (the last row among them) that the pointers
        and home slots name; the home slots come from 256 of them, so
        rows are shared. Returns the live group-bit copies whose
        fill-time epoch differs from their entry's (0 on a full map) and
        the GETS-probe winners whose row's old sharer words hold bit 31
        (MOESI keeps those bits)."""
        C, S1, W1 = mcfg.n_cores, mcfg.l1.sets, mcfg.l1.ways
        W2, NW = mcfg.llc.ways, mcfg.n_sharer_words
        MW, DW, FS = llc_meta_width(mcfg), dirm_width(mcfg), W1 * S1
        NS, rl = mcfg.n_banks * mcfg.llc.sets, mcfg.local_run_len
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
        rows = np.zeros((len(pool), DW), np.int64)
        rows[:, 0 : 2 * W2 : 2] = rng.integers(-1, n_lines, (len(pool), W2))
        rows[:, 1 : 2 * W2 : 2] = rng.integers(-1, C, (len(pool), W2))
        rows[:, 2 * W2 : 4 * W2] = rng.integers(0, 3, (len(pool), 2 * W2))
        rows[:, MW:] = words((len(pool), W2 * NW))
        at = {r: i for i, r in enumerate(pool)}
        cc, ww = np.nonzero(rng.random((C, W1)) < 0.5)  # live copies, a third owned
        for c, w in zip(cc, ww):
            i, pway = at[ptr[c, w] // W2], ptr[c, w] % W2
            rows[i, 2 * pway] = l1[c, cols[c, w]]
            if rng.random() < 0.3:
                rows[i, 2 * pway + 1] = c
        mismatched = 0
        if mcfg.sharer_group > 1:  # group-bit copies whose epoch moved on
            i = np.vectorize(at.get)(ptr // W2)
            pway = ptr % W2
            g = (np.arange(C) >> (mcfg.sharer_group.bit_length() - 1))[:, None]
            word = rows[i, MW + pway * NW + (g >> 5)] & 0xFFFFFFFF
            rc = np.arange(C)[:, None]
            mismatched = int((
                (l1[rc, FS + cols] != 0) & (rows[i, 2 * pway] == l1[rc, cols])
                & (rows[i, 2 * pway + 1] != rc) & (((word >> (g & 31)) & 1) != 0)
                & (rows[i, 3 * W2 + pway] != l1[rc, 4 * FS + cols])
            ).sum())
            if not mismatched:
                fail("kernels: no group-bit copy meets a changed epoch")
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
        ], mcfg=mcfg)
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
        ], mcfg=mcfg)
        old_bit31 = (pc_out[3] < 0).any(1).cpu().numpy()
        probe_bit31 = int((
            (lanes[:, step_kernels.CL_WINNER] != 0) & (lanes[:, step_kernels.CL_LLC_HIT] != 0)
            & (lanes[:, step_kernels.CL_GETS_PROBE] != 0) & old_bit31).sum())
        del dirm, pc_out
        torch.cuda.empty_cache()
        return mismatched, probe_bit31

    step_kernels_random(cfg)
    epoch_mismatches = step_kernels_random(cfg5)[0]  # 64-core groups, epochs
    moesi_probe_bit31 = step_kernels_random(cfg_hm)[1]  # the MOESI commit
    if not moesi_probe_bit31:
        fail("kernels: no MOESI GETS-probe winner's row holds sharer bit 31")

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

    # the headline's 32 words, then padding bits (40 cores on 16 tiles),
    # more words than lanes (1100 cores: 35 words) and rung 4's 128 words
    compare("sharer_reductions", sharer_args(cfg))
    spec = json.loads(cfg.to_json())
    for n, mx, my in ((40, 4, 4), (1100, 44, 25)):
        mcfg = MachineConfig.from_dict({**spec, "n_cores": n, "noc": {
            **spec["noc"], "mesh_x": mx, "mesh_y": my}})
        compare("sharer_reductions", sharer_args(mcfg), mcfg=mcfg)
    compare("sharer_reductions", sharer_args(cfg4), mcfg=cfg4)

    # the group mode at rung 5: sparse and dense group words, a quarter of
    # the rows invalidating with the requester's own group flagged, a
    # quarter evicting with the owner outside the victim's flagged groups
    n, G = cfg5.n_cores, cfg5.sharer_group
    ga = sharer_args(cfg5)
    sh, vsh = words((n, cfg5.n_sharer_words)), words((n, cfg5.n_sharer_words))
    sparse = rng.random(n) < 0.5
    sh[sparse] &= words((int(sparse.sum()), cfg5.n_sharer_words))
    own = rng.integers(-1, n, n)
    gs, og = np.arange(n) // G, np.maximum(own, 0) // G
    self_rows, out_rows = rng.random(n) < 0.25, rng.random(n) < 0.25
    sh.view(np.uint32)[self_rows, gs[self_rows] >> 5] |= (
        np.uint32(1) << (gs[self_rows] & 31).astype(np.uint32))
    out_rows &= own >= 0
    vsh.view(np.uint32)[out_rows, og[out_rows] >> 5] &= ~(
        np.uint32(1) << (og[out_rows] & 31).astype(np.uint32))
    ga[0], ga[1], ga[3] = cu(sh), cu(vsh), cu(own)
    ga[4][torch.from_numpy(self_rows).to(dev)] = True
    ga[5][torch.from_numpy(out_rows).to(dev)] = True
    compare("sharer_reductions", ga, {"tables": group_tables(cfg5, dev)}, mcfg=cfg5)
    group_rows = {"requester_group_flagged": int(self_rows.sum()),
                  "owner_outside_flagged_groups": int(out_rows.sum())}
    del ga

    # the topology modes: the IPU's 32x46 torus (1472 cores, 46 words), a
    # ring of odd sizes (40 cores on 5x3: padding bits, tiles shared), and
    # the group mode's tables and corrections on a 16x16 torus
    compare("sharer_reductions", sharer_args(cfg_ipu), mcfg=cfg_ipu)
    ring40 = MachineConfig.from_dict({**spec, "n_cores": 40, "noc": {
        **spec["noc"], "mesh_x": 5, "mesh_y": 3, "topology": "ring"}})
    compare("sharer_reductions", sharer_args(ring40), mcfg=ring40)
    spec5 = json.loads(cfg5.to_json())
    torus_g4 = MachineConfig.from_dict({
        **spec5, "n_cores": 256, "n_banks": 256, "sharer_group": 4,
        "noc": {**spec5["noc"], "mesh_x": 16, "mesh_y": 16, "topology": "torus"}})
    compare("sharer_reductions", sharer_args(torus_g4),
            {"tables": group_tables(torus_g4, dev)}, mcfg=torus_g4)

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
        "sharer_cores": [C, 40, 1100, cfg4.n_cores],
        "coarse": {"C": cfg5.n_cores, "G": cfg5.sharer_group,
                   "NW": cfg5.n_sharer_words, "DW": dirm_width(cfg5),
                   "epoch_mismatched_copies": epoch_mismatches, **group_rows},
        "zoo": {"commit_moesi_C": cfg_hm.n_cores,
                "moesi_gets_probe_rows_with_bit31": moesi_probe_bit31,
                "torus": {"C": cfg_ipu.n_cores, "NW": cfg_ipu.n_sharer_words,
                          "grid": [cfg_ipu.noc.mesh_x, cfg_ipu.noc.mesh_y]},
                "ring": {"C": 40, "grid": [5, 3]},
                "torus_group": {"C": 256, "G": 4, "grid": [16, 16]}}},
        "traces_s": traces_s, "max_abs_err": max_err})

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

    # ---- reduced: the coarse vector and the chunked full map at 256
    # cores, card == CPU to completion
    small_tr = fold_ins(synth.fft_like(256, n_phases=8, points_per_core=16,
                                       ins_per_mem=8, seed=42))
    stream_tr = fold_ins(synth.stream(256, n_mem_ops=128, seed=42))
    rw_tr = fold_ins(synth.readers_writer(256, n_rounds=8, seed=42))
    reduced = {}
    for name, big, kw, noc, rtr in (
            ("rung5_G4", cfg5, {"sharer_group": 4}, {}, small_tr),
            ("rung4_K2", cfg4, {"sharer_chunk_words": 2}, {}, small_tr),
            ("ring_stride", cfg_ipu, {}, {"topology": "ring"}, stream_tr),
            ("torus_moesi", cfg_hm, {}, {"topology": "torus"}, rw_tr)):
        spec = json.loads(big.to_json())
        mcfg = MachineConfig.from_dict({
            **spec, **kw, "n_cores": 256, "n_banks": 256,
            "noc": {**spec["noc"], "mesh_x": 16, "mesh_y": 16, **noc}})
        gpu = Engine(mcfg, rtr, chunk_steps=128, device=dev)
        reset_launches()
        gpu.run()
        n_launch = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        cpu = Engine(mcfg, rtr, chunk_steps=128, device="cpu")
        cpu.run()
        cpu_s = time.perf_counter() - t0
        for k, n in n_launch.items():
            if n != (gpu.steps_run if k in STEP_KERNELS else 0):
                fail(f"reduced {name}: {k} launched {n} times in {gpu.steps_run} steps")
        same_run(f"reduced {name}", gpu, cpu)
        gpu.verify_invariants()
        sums = {k: int(gpu.counters[k].sum())
                for k in ("invalidations", "probes", "prefetch_hits")}
        if name == "ring_stride" and not sums["prefetch_hits"]:
            fail("reduced ring_stride: the stride prefetcher covered no miss")
        reduced[name] = {"steps": gpu.steps_run, "sharer_words": mcfg.n_sharer_words,
                         "sharer_group": mcfg.sharer_group,
                         "sharer_chunk_words": mcfg.sharer_chunk_words,
                         "topology": mcfg.noc.topology, "coherence": mcfg.coherence,
                         "prefetcher": mcfg.prefetcher, **sums,
                         "cpu_s": cpu_s, "launches": n_launch}
        del gpu, cpu
    emit({"phase": "reduced", "card_equals_cpu": True, "machines": reduced})

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

    def timed_call(k, args, kw, mcfg=None):
        """(launch, prep): one wrapper call on a step's staged inputs, and
        what restores the tensors it updates in place beforehand (outside
        the timed window). commit_step changes only the directory rows its
        lanes name (column CL_SLOT), so only those rows are restored: a
        copy of the whole directory would leave L2 full of dirty lines."""
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
        return (lambda fn: call(fn, k, work, kw, mcfg)), prep

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

    def time_alone(k, args, kw, mcfg=None):
        """The kernel's and its plain version's event times on staged
        inputs."""
        launch, prep = timed_call(k, args, kw, mcfg)
        return {
            "ms": device_ms(lambda: launch(wrappers[k]), 4_000_000, prep),
            "plain_ms": device_ms(lambda: launch(plains[k]), 100_000_000, prep),
        }

    timing = {k: time_alone(k, *captured[k]) for k in wrappers}
    event_floor_ms = device_ms(lambda: torch.cuda._sleep(0), 4_000_000)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))

    # the bytes each function needs on a step's inputs, as the main path
    # stages them: every word it reads, once, and every output word, once
    def probe_bound(a, mcfg):  # l1 dirm slot line cid step hm wm cm
        C, W1, W2, NW = mcfg.n_cores, mcfg.l1.ways, mcfg.llc.ways, mcfg.n_sharer_words
        coarse = mcfg.sharer_group > 1
        b = (4 * C * (4 * W1  # tag, state, LRU, pointer: the accessed set's ways
                      + 3 * W1  # tag, owner, own sharer word at each way's pointer
                      + (2 * W1 if coarse else 0)  # fill-time and entry epochs
                      + 2 * W2 + 4  # home row: tags, LRUs, two owners, two epochs
                      + 2 * NW)  # the hit and victim ways' sharer words
             + nbytes(*a[2:])  # slot, line, cid, step, run patch
             + 4 * C * (3 * W1 + 2 * NW + step_kernels.PROBE_LANES))  # out
        return b, {"bytes": b}

    def commit_bound(a, mcfg):
        """In place: the L1 and directory words it changes (the old
        directory words come from the probe's lanes), the counters in and
        out with the delta, the lanes and the probe outputs it reads."""
        # l1 dirm tag shw vic_shw lanes pc cid step counters delta hm wm cm
        C, NW = mcfg.n_cores, mcfg.n_sharer_words
        new_l1, new_dirm, _ = outputs(wrappers["commit_step"], "commit_step", a, mcfg=mcfg)
        rows = torch.unique(a[5][:, step_kernels.CL_SLOT]).long()  # all it may change
        l1_words = int((new_l1 != a[0]).sum())
        dirm_words = int((new_dirm[rows] != a[1][rows]).sum())
        del new_l1, new_dirm
        win = a[5][:, step_kernels.CL_WINNER] != 0
        n_win = int(win.sum())
        n_join = int(((a[5][:, step_kernels.CL_JOIN] != 0) & ~win).sum())
        b = (4 * (l1_words + dirm_words)
             + 3 * nbytes(a[9])  # counters in and out, delta in
             + nbytes(a[2], a[5], *a[7:9], *a[11:])  # tag rows, lanes, cid, step, patch
             + 4 * C * 8  # the home-row words of the probe's lanes
             + 4 * (n_win * NW + n_join))  # old sharer words, a joiner's own word
        return b, {"bytes": b, "winners": n_win, "joiners": n_join,
                   "words_changed": {"l1": l1_words, "dirm": dirm_words}}

    def set_bits(words, rows, n_bits):
        """[rows, 32*NW] bool: the set bits below n_bits of the rows' words."""
        t = torch.arange(32 * words.shape[1], device=dev)
        bits = ((words[rows][:, t >> 5] >> (t & 31)) & 1) != 0
        return bits & (t < n_bits)

    def sharer_bound(a, kw, mcfg):
        """Both flag bytes of every row, the lanes and sharer words of the
        active rows, the outputs; per set bit of those words, the full map
        computes a hop count, the group mode reads table words (memb[g]
        and the home tile's max and summed hops, each distinct word
        once)."""
        # shw vic_shw btile vic_owner inv_row vic_valid cid link router
        C, NW = mcfg.n_cores, mcfg.n_sharer_words
        irow, vv = a[4], a[5]  # bool
        n_inv, n_vic = int(irow.sum()), int(vv.sum())
        active_rows = int((irow | vv).sum())
        coarse = mcfg.sharer_group > 1
        n_bits = mcfg.n_sharer_groups if coarse else C
        inv_b = set_bits(a[0], irow, n_bits)
        back_b = set_bits(a[1], vv, n_bits)
        inv_bits, back_bits = int(inv_b.sum()), int(back_b.sum())
        b = (nbytes(a[4], a[5], a[7], a[8])  # both flag bytes of every row, two latencies
             + 4 * 3 * active_rows  # btile, vic_owner, cid of the active rows
             + 4 * NW * (n_inv + n_vic)  # the sharer words of those rows
             + 4 * 5 * C)  # the five outputs
        info = {"active": active_rows, "invalidating": n_inv, "evicting": n_vic,
                "invalidation_bits": inv_bits, "back_invalidation_bits": back_bits}
        if coarse:
            n_grp = mcfg.n_sharer_groups

            def pairs(bits, rows):  # distinct (home tile, group) of set bits
                bt = a[2][rows].long()[:, None]
                g = torch.arange(bits.shape[1], device=dev)[None, :]
                return torch.unique(torch.masked_select(bt * n_grp + g, bits))

            max_words = pairs(inv_b, irow)
            sum_words = torch.unique(torch.cat([max_words, pairs(back_b, vv)]))
            memb_words = torch.unique(torch.cat([max_words, sum_words]) % n_grp)
            table_words = len(max_words) + len(sum_words) + len(memb_words)
            b += 4 * table_words
            info["table_words"] = table_words
            # per set bit: find and clear it, three table loads, two sums,
            # and for the invalidation set the latency and its max
            ops = 5 * NW * (n_inv + n_vic) + 13 * inv_bits + 7 * back_bits
        else:
            # per word read: mask, popcount, sum; per set bit: find and
            # clear it, the target's tile, its hop count and the hop sum,
            # and for the invalidation set the latency and its max; the
            # torus's and the ring's hop count take 4 more (the shorter
            # way around each ring)
            hop_extra = 0 if mcfg.noc.topology == "mesh" else 4
            ops = (5 * NW * (n_inv + n_vic) + (16 + hop_extra) * inv_bits
                   + (12 + hop_extra) * back_bits)
        info["ops"] = ops
        return max((b / HBM_BYTES_PER_S * 1e3, "bytes"),
                   (ops / INT_OPS_PER_S * 1e3, "operations")), info, b

    def bound_of(k, a, kw, mcfg):
        """((ms, "bytes" or "operations"), detail, bytes) of a step
        kernel on staged inputs."""
        if k == "sharer_reductions":
            return sharer_bound(a, kw, mcfg)
        b, info = (probe_bound if k == "probe_classify" else commit_bound)(a, mcfg)
        return (b / HBM_BYTES_PER_S * 1e3, "bytes"), info, b

    a_h = {k: staged[k][300] for k in STEP_KERNELS}
    step_bounds = {k: bound_of(k, *a_h[k], cfg) for k in STEP_KERNELS}
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
    bounds = {k: step_bounds[k][0] for k in STEP_KERNELS}
    bounds["router_cascade"] = max(
        (cas_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        (cas_ops / INT_OPS_PER_S * 1e3, "operations"),
    )
    capture_line = {"phase": "capture", "steps": CAPTURE, "timed_step": timed_step,
          "card_equals_cpu_steps": CHECK_STEPS, "cpu_s": check_s,
          "max_abs_err": max_err, "timing_ms": timing,
          "event_floor_ms": event_floor_ms, "profiler_reps": PROF_REPS,
          "bytes": {**{k: step_bounds[k][2] for k in STEP_KERNELS},
                    "router_cascade": cas_bytes},
          "commit": step_bounds["commit_step"][1],
          "sharer_rows": step_bounds["sharer_reductions"][1],
          "router_hops": {"legs": legs, "live": n_ok, "live_by_leg": live_by_leg,
                          "all": a[3].numel()},
          "gpu": smi_line}
    del staged  # the other staged steps, before the main paths' peaks

    # ---- 6./7. the main paths, each with the counts set to 0 just before
    launches = {}
    main_paths = [("headline", cfg, hfx, trace, STEP_KERNELS),
                  ("rung3", cfg3, r3fx, trace3, tuple(wrappers))]
    main_paths += [(path, fxs[path][1], fxs[path][0], fxs[path][2], STEP_KERNELS)
                   for fxs, paths in ((large, LARGE), (zoo, ZOO)) for path, _ in paths]
    sums_of = {}
    for path, pcfg, fx, ptrace, ran in main_paths:
        held = torch.cuda.memory_allocated()  # the timed step's inputs, kept for phase 8
        eng = Engine(pcfg, ptrace, chunk_steps=fx["chunk_steps"], device=dev)
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
        sums = sums_of[path] = got["counter_sums"]
        emit({"phase": path, "steps": eng.steps_run, "wall_s": wall,
              "simulated_mips": ins / wall / 1e6, "peak_memory_bytes": peak,
              "launches": launches[path], "instructions": ins,
              "max_core_cycles": got["max_core_cycles"],
              "noc_msgs": sums["noc_msgs"],
              "noc_contention_cycles": sums["noc_contention_cycles"],
              "dram_queue_cycles": sums["dram_queue_cycles"],
              **{k: sums[k] for k in ("probes", "barrier_waits", "prefetch_hits")},
              "digest": {k: v for k, v in got.items() if k.endswith("sha256")},
              "equals_jax_digest": got == fx["digest"], "gpu": smi_line})
        for k, n in launches[path].items():
            if n != (eng.steps_run if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {eng.steps_run} steps")
        if ins != ptrace.total_instructions():
            fail(f"{path}: {ins} instructions retired, trace has {ptrace.total_instructions()}")
        for k, want in fx["digest"].items():
            if got[k] != want:
                fail(f"{path}: {k} {got[k]} != the JAX package's {want}")
        if not eng.done():
            fail(f"{path}: not every core reached END")
        if path == "ipu" and not (sums["barrier_waits"] and sums["prefetch_hits"]):
            fail(f"ipu: {sums['barrier_waits']} barrier waits and "
                 f"{sums['prefetch_hits']} prefetch hits: both must be nonzero")
        if path == "headline_moesi" and sums["probes"] == sums_of["headline"]["probes"]:
            fail("headline_moesi: as many probes as the MESI headline")
        if path == "zoo_smoke":
            cpu = Engine(pcfg, ptrace, chunk_steps=fx["chunk_steps"], device="cpu")
            cpu.run()
            same_run(path, eng, cpu)
            del cpu
        t0 = time.perf_counter()
        eng.verify_invariants()
        if path in MODE_PATHS:
            emit({"phase": f"{path} invariants", "seconds": time.perf_counter() - t0})
        del eng
        torch.cuda.empty_cache()

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

    def stage_busiest_step(eng):
        """Run one more chunk of `eng` and keep the step kernels' inputs of
        its busiest step: the one whose sharer_reductions gets the most
        rows that invalidate or evict. Each tensor argument is cloned once
        (the L1 and the directory, which several kernels take, are written
        only by commit_step, last in the step, so the clones made at the
        reduction's call hold the probe's inputs too). Returns (step,
        {kernel: (args, kw)})."""
        best = {"rows": -1}
        cur = {"step": eng.steps_run - 1}

        def grab(memo, x):
            if not torch.is_tensor(x):
                return x
            if id(x) not in memo:
                memo[id(x)] = (x, x.clone())  # the original keeps its id
            return memo[id(x)][1]

        def recorder(name):
            real = wrappers[name]

            def rec(mcfg, *args, **kw):
                if name == "probe_classify":
                    cur.update(step=cur["step"] + 1, probe=(args, kw), take=False)
                elif name == "sharer_reductions":
                    rows = int((args[4] | args[5]).sum())  # a sync: staging only
                    if rows > best["rows"]:
                        memo = {}
                        best.clear()
                        best.update(rows=rows, step=cur["step"], memo=memo, got={
                            k: ([grab(memo, x) for x in a], kw_)
                            for k, (a, kw_) in (("probe_classify", cur["probe"]),
                                                (name, (args, kw)))})
                        cur["take"] = True
                elif cur["take"]:  # commit_step of the step just kept
                    best["got"][name] = ([grab(best["memo"], x) for x in args], kw)
                return real(mcfg, *args, **kw)
            return rec

        for k in STEP_KERNELS:
            setattr(mods[k], k, recorder(k))
        try:
            eng.run_steps(eng.chunk_steps)
        finally:
            for k in STEP_KERNELS:
                setattr(mods[k], k, wrappers[k])
        if set(best.get("got", ())) != set(STEP_KERNELS):
            fail(f"stage: no step with every step kernel after step {cur['step']}")
        return best["step"], best["got"]

    kernel_us, modes = {}, {}
    by_path = {p: (pc, pt, r) for p, pc, _, pt, r in main_paths}
    for path in ("headline", "rung3", *MODE_PATHS):
        pcfg, ptrace, ran = by_path[path]
        prof_eng = Engine(pcfg, ptrace, chunk_steps=64, device=dev)
        prof_eng.run_steps(256)  # mid-run state, as the main path meets it
        torch.cuda.synchronize()
        dev_ev, window_s, top_ops = device_events(lambda: prof_eng.run_steps(64), by_op=True)
        mode_in = stage_busiest_step(prof_eng) if path in MODE_PATHS else None
        del prof_eng
        torch.cuda.empty_cache()
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
        if mode_in is None:
            continue
        # the large path's kernels alone on the staged step: held to their
        # plain versions, timed by events, bounded
        staged_step, mode_in = mode_in
        modes[path] = {}
        for k in STEP_KERNELS:
            args, kw = mode_in[k]
            compare(k, args, kw, mcfg=pcfg)
            bnd, info, nb = bound_of(k, args, kw, pcfg)
            modes[path][k] = {
                **time_alone(k, args, kw, pcfg), "profiler_us_in_step": kernel_us[path][k],
                "launches": launches[path][k], "bound_ms": bnd[0], "bound_by": bnd[1],
                "bytes": nb, "detail": info,
            }
        del mode_in
        torch.cuda.empty_cache()
        emit({"phase": "mode", "path": path, "staged_step": staged_step,
              "kernels": modes[path], "max_abs_err": max_err,
              "event_floor_ms": event_floor_ms, "gpu": smi_line})

    machine_of = {p: {"topology": by_path[p][0].noc.topology,
                      "coherence": by_path[p][0].coherence,
                      "sharer_group": by_path[p][0].sharer_group,
                      "sharer_words": by_path[p][0].n_sharer_words}
                  for p in modes}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1],
         "launches": launches["rung3" if k in RUNG3_STAGED else "headline"][k],
         "launches_by_path": {p: launches[p][k] for p in launches},
         "max_abs_err": max_err[k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"],
         "profiler_us_per_launch": timing[k]["profiler_us"],
         "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": None,
         "kernel_modes": KERNEL_MODES[k],
         "modes": {p: {"machine": machine_of[p],
                       **{f: m[k][f] for f in ("launches", "ms", "plain_ms",
                                               "profiler_us_in_step", "bound_ms",
                                               "bound_by")}}
                   for p, m in modes.items() if k in m}}
        for k in wrappers
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
