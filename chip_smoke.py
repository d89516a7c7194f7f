#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (primesim_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the final line (`chip_smoke.py --child PATH` runs one phase of 14 or 15 in a
process of its own: the script starts it so):

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
   cli_faults -- `python -m primesim_tpu_torch run` on rung 1 with a fault
                schedule and --fault-seed 7, once on the card and once with
                --device cpu: the same summary numbers and FAULTS section.
                Its processes, cli_xml's and cli_sweep's run at once.
   cli_xml   -- `run configs/example_prime.xml --synth fft_like:n_phases=2
                --fold --debug-invariants` (the reference-schema XML config,
                the invariants after every chunk), once on the card and once
                with --device cpu: the same summary but for the wall time.
   reduced   -- the two large-core directory modes at 256 cores: rung 5's
                machine with 4-core groups and rung 4's with a 2-word
                chunk, each on a folded fft_like(256, 8 phases, 16
                points) trace, run to completion on the card and on the
                CPU: equal in every field, the step kernels launched once
                per step. Likewise two 256-core zoo machines on a 16x16
                grid: a ring with the stride prefetcher on
                stream(256, 128 ops) and a torus under MOESI on
                readers_writer(256, 8 rounds), which the CPU repeats to
                step 384 only (CPU_DEPTH: the card's state there is kept).
   reduced_faults -- three fault machines at 256 cores on 16x16 grids, run
                to completion on the card and on the CPU: equal in every
                state field, the fault state included, the step kernels
                launched once per step. A torus on barrier_phases(256, 8
                phases, 16 lines) under the "drop" policy, DUE fail-stops
                (flip_l1 1e-3) and two scheduled kills, the second
                (TORUS_KILL) of a running core while others wait at a
                barrier: fails unless that premise holds on the card, the
                run completes and barrier waits grow after the kill. A
                ring on lock_contention(256, 3 sections, 2 locks) with a
                failed and a degraded row link and the kill of a lock
                holder (RING_KILL): fails unless the core holds the slot
                at the kill step and not after it (the CPU repeats this
                ring to step 384 only). Rung 3's router machine
                on fft_like(256, 4 phases, 32 points) with two failed
                links and flip_llc 1e-3 (router_cascade once per step).
5. capture   -- the first 320 steps of the headline machine and of rung 3
                on the card (chunks of 64), the first 64 of them equal
                to the port's CPU run of them in per-core
                cycles, all 26 counters and every state field, and to the
                JAX package's digest at step 64 (fixtures/headline_cut.json,
                rung3_headline_cut.json). Meanwhile the kernel inputs staged at steps 1 and 300
                (the headline's, and rung 3's router_cascade) are kept;
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
                on the same trace to step 1024 (MAIN_CUT), likewise: all
                four kernels once per step, the
                digest against the JAX package's there
                (fixtures/rung3_headline_cut1024.json), invariants.
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
                memory op, seed 42) trace to step 1024 (MAIN_CUT), against
                fixtures/ipu_cut.json there:
                the step kernels once per step, router_cascade never; the
                phase fails unless barrier waits and prefetch hits are
                both nonzero (the first card path with sync events).
   headline_moesi -- the headline machine under MOESI on the headline
                trace, against fixtures/headline_moesi.json; the phase
                fails if its probes equal the MESI headline's.
   headline_faults -- the headline machine under the committed fault
                schedule (fixtures/headline_faults_schedule.json: two
                failed and two degraded links, three scheduled kills, L1
                and LLC flips and DUE fail-stops, seed 7) on the headline
                trace, against fixtures/headline_faults.json; fails if a
                fault counter sums to 0 or the whole-directory scrub ran on
                no step or on more than one in 16. Prints the dead cores
                and the scrub's steps.
   rung2     -- the shipped configs/rung2_256core_parsec.json (256 cores,
                16x16 mesh) on a folded fft_like(256, 4 phases, 128 points,
                seed 42) trace, likewise against fixtures/rung2_full.json.
   multiprog_rung3 -- rung 3's shipped machine on four 256-core programs
                multiplexed into its 1024 cores (fixtures/multiprog_rung3.json:
                an FFT, barrier_phases, lock_contention and readers_writer),
                the programs written as PTPU files by the port's synth verb
                and loaded through the CLI's loader. With the flight recorder
                attached, it runs to step 1024, is checkpointed and freed; a
                fresh engine loads the checkpoint and runs to step 1536
                (MP_DEPTH). Fails unless the digest equals the JAX
                package's at that depth (fixtures/multiprog_rung3_cut.json),
                every kernel launched once per step and router_cascade every
                time with its barrier-arrival leg, locks and barriers both
                ran, the invariants hold, and the recorder holds one sample
                and one chunk span per chunk whose instruction deltas sum to
                the digest's. Prints the checkpoint's bytes and save and load
                seconds. The state at step 1536 is snapshotted for:
   cli_multiprog -- the same four PTPU files through `python -m
                primesim_tpu_torch run configs/rung3_1024core_o3.json
                --trace ... (4) --fold --chunk-steps 512 --obs full
                --metrics-out --trace-out --report --per-core-limit 16
                --checkpoint-dir D --resume` on the card, resumed from that
                snapshot and run to the end: the summary's instructions,
                max_core_cycles and noc_msgs equal the whole run's JAX
                digest, one metrics line per chunk run, a trace that loads,
                a TIMELINE section; prints the mean dispatch/drain/rebase
                split of a chunk.
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
                The faulted headline gets a window too, and 64 of its
                steps (256-319, the scheduled kill's scrub first) run
                under CUDA's sync debug mode: the phase fails on any
                synchronising call. Last, the ring mode of
                sharer_reductions: the reduced ring machines (ring_stride,
                ring_faults) are staged at their busiest step of a
                64-step chunk (steps 0-63 and 256-319) and get "mode"
                lines. The multiprogrammed path gets a window too; then,
                of its first 512 steps, router_cascade's inputs at the step
                whose barrier-arrival leg has the most live hops are staged,
                held to the plain version, timed and bounded (a "mode" line
                of the three legs). Last, one chunk of that path with a
                Recorder attached, under the sync debug mode: it must make
                exactly one synchronising call (its one transfer).
3b. kernels_batched -- each kernel with a leading batch axis, one launch for
                B elements, against its batched plain version, exactly,
                on random inputs as in phase 3, each element with its own
                inputs, step number and link and router latencies
                (FLEET_LATS): the three step kernels at the headline's
                shapes with B = 8 (element B-1's last core homes at the
                directory's last row; element 1 commits nothing; element
                1 has no invalidating or evicting row), router_cascade at
                rung 3's with B = 4, two legs and three (element 2 has no
                live hop). Printed after phase 3.
9. fleet_headline -- sim/fleet.py's FleetEngine on the headline machine,
                B = 8, chunk_steps 512: seven elements on the headline
                trace with their own timing overrides, one on a two-phase
                trace of seed 43 that finishes chunks early and freezes
                (fixtures/fleet_headline.json names them), run to
                completion with the launch counts set to 0 just before:
                each step kernel launched once per fleet step for the
                whole batch, every element's digest equal to the
                committed JAX one, element 0's equal to the solo
                headline's, the short element finished first. Prints the
                aggregate MIPS and the fleet's peak device memory.
   fleet_rung3 -- the shipped rung 3, B = 4 (fixtures/fleet_rung3.json),
                run to step 512 (FLEET_CUT), checkpointed, freed, resumed in
                a fresh fleet and run to step 1024 (FLEET_DEPTH); all four kernels
                once per fleet step; every element's digest equal to the
                JAX package's at that depth (fixtures/fleet_rung3_cut.json).
   cli_sweep -- `python -m primesim_tpu_torch sweep` on rung 1 with three
                --vary sets, one a duplicate, on the card and with
                --device cpu side by side (run beside cli_faults): the same
                lines but for wall seconds and MIPS, the same dedup
                warning. Printed before phase 8.
   fleet_scaling -- after phase 8: the headline fleet's first B = 1, 4, 8
                elements, 128 steps from step 0 in chunks of 64 (aggregate
                MIPS), then a profiled 64-step window (events and busy
                time a step), and a profiled window of steps 0-63 of the
                B = 1 fleet with its sync phase forced on as a serving
                fleet runs it (its extra device events a step);
                fleet_profile: the rung-3 fleet's window of
                steps 256-319. Recorded, not gated.
   fleet_kernels -- each batched kernel alone (CUDA events, its plain
                version, a bound from the inputs) on the step after the
                B = 8 window (step kernels) and after the rung-3 fleet's
                window (router_cascade, B = 4), held to its plain version.

10. supervised_faults (after cli_sweep, before phase 8: no profiler
                session precedes it) -- the faulted headline (fixtures/
                headline_faults_schedule.json, seed 7, 1536 steps) in
                chunks of 256 under sim/supervisor.py's RunSupervisor, with
                a snapshot directory in a temporary folder, a snapshot every
                two chunks, two kept, the guard off, and a SoloAttest chain:
                a SIGTERM sent from the
                on_chunk callback at committed chunk 2 preempts it (a
                snapshot at step 512); a fresh engine resumes from that
                snapshot, and its first chunk runs on the card and then
                raises UNAVAILABLE, so the supervisor rolls the device state
                and the chain back and retries; a second SIGTERM preempts it
                after that chunk (SUP_STOP_CHUNK, step 768). Fails unless
                the resumed chain is the JAX run's after chunk 2 and the
                head after chunk 3 the uninterrupted JAX run's there
                (fixtures/attest_faults.json: a hash of every state field),
                and each step kernel
                launched once per step run, the failed chunk's included. Prints the
                snapshots written, the retries, the snapshot's bytes, save
                and load seconds, the rollback copy's bytes and CUDA-event
                time, the wall and the peak device memory beside the
                unsupervised headline_faults run's.
   fleet_fork -- the headline machine as a B = 4 fleet on the headline
                trace under fixtures/fleet_fork.json's rates-0 schedule
                (core 1023 fail-stops at step 1024, link 2112 fails at
                1280): sim/prefix.py must plan one group, elements 0-2, with
                a 1024-step prefix (element 3's dram_lat keeps it alone);
                the prefix runs once as a solo engine, is stored in a warm
                cache in a temporary folder and forked into the three slots,
                and the fleet runs 512 steps past the fork (FORK_CHECK;
                element 3 from step 0): every element's digest equals the
                committed JAX one there (fixtures/fleet_fork_cut.json).
                fleet_fork_warm: a second fleet from the same cache, a hit
                that simulates no prefix, run as far and equal there to the
                JAX digests and to fleet_fork's. The launches count the
                prefix's steps and the fleet's.
   cli_supervised (in the background thread of dispatch_rung2, after
                it; printed before phase 5) -- through
                cli_side_by_side on rung 1: `run
                --checkpoint-dir D --checkpoint-every 2 --guard fail
                --attest chain`, then the same command with --resume (a
                no-op rerun from the final snapshot, equal key for key, the
                chain included), and a forked seed sweep
                (`--fork-prefix auto --warm-cache on`, a rates-0 schedule,
                three seeds) run twice against one cache per device: the
                prefix_fork line reads cache_hits 0, then 1; card = CPU.

11. stream_headline (after cli_supervised, before phase 8) -- the
                headline trace written as a PTPU file, memory-mapped and run
                to completion by ingest/stream.py's StreamEngine through
                256-event windows on the card: the digest (exact steps and
                the window count included) must equal the JAX StreamEngine's
                (fixtures/stream_headline.json) and fixtures/headline.json's
                in every field but the chunk-rounded steps; each step kernel
                launched once per executed step. Prints the windows, the
                chunks (host transfers) per window, the wall and MIPS beside
                the preloaded headline's in this call, and the peak device
                memory beside its.
   stream_rung5 -- likewise rung 5 at full geometry (16384 cores) through
                128-event windows, against fixtures/stream_rung5.json and
                fixtures/rung5_full.json without steps.
   stream_snapshot -- the streamed headline cut by run_events at about
                half its events, snapshotted, resumed in a fresh
                StreamEngine and finished: the same digest. Prints the
                snapshot's bytes and its save and load seconds.
   sync_check (stream_headline) -- one window chunk, its drain and rebase
                included, makes exactly one synchronising call.
   cli_stream -- `run configs/rung1_64core_fft.json --trace F --mmap
                --stream-window 64 --checkpoint-every 2 --attest chain` in
                process, on the card and with --device cpu: uninterrupted,
                preempted by a SIGTERM at its third committed window (exit
                75), resumed with --resume; card == CPU and resume == run,
                the window-scoped chain included, the step
                kernels launched once per card step; faults with
                --stream-window are refused with primetpu's message.
   online     -- the port's capture shim (built with g++ into _build/) and
                its ocean_like (gcc; 4 threads, 5 cores) captured through
                the shared-memory rings while ingest/ring.py's OnlineEngine
                simulates them on the card: the target exits 0, no event
                is dropped, and the result equals the preloaded Engine on
                the captured stream (src.to_trace()) on the card, which
                equals it on the CPU; `capture --out` writes a trace that
                the card and the CPU simulate alike.

12. attest_headline (after online, before phase 8) -- the headline run
                to step 512 (ATTEST_DEPTH: one chunk of 512) with a
                SoloAttest chain: the head after
                every chunk, a hash of every state field, equal to the JAX
                package's (fixtures/attest_headline.json; a mismatch names
                the first chunk whose committed state differs), each step
                kernel once per step. Prints the wall beside the unattested
                headline's (and its steps), the bytes hashed and the
                transfer and hash seconds of each chunk.
   serve_headline -- `python -m primesim_tpu_torch serve` on the headline
                machine as a child process: one bucket of 3 slots of
                ceil(T / 64) pages, --chunk-steps 512, --attest chain, no
                checkpoint during the run; fleet_headline's elements 0, 1
                and 7 (SERVE_ELEMENTS) submitted by three `submit --synth
                ... --fold --vary ...` processes at once. Every result's steps, instructions,
                max core cycles, cycle and counter hashes and counter sums
                equal the element's JAX digest and its chain head a JAX
                solo run's at cadence 512 (fixtures/serve_headline.json;
                element 0's is attest_headline's last head). The daemon's
                health reports its fleet steps and kernel launches (each
                step kernel once per fleet step) and its peak device
                memory; prints the jobs' wall and aggregate MIPS.
   serve_recover (run beside the CLI phases of step 4, printed after
                cli_xml) -- the daemon on the shipped rung-2 machine (256
                cores), four jobs (fixtures/serve_rung2.json), started with
                PRIMETPU_CHAOS_PLAN set to kill it (SIGKILL) at its first
                `scheduler.post-checkpoint` (2 s of wall between
                checkpoints; the jobs submitted at once), then restarted on
                the same state directory:
                the kill lands mid-service with element checkpoints on
                disk, the journal replays with no job lost, and every job
                ends DONE with results and chain heads equal to the JAX
                runs'.
   sync_check (attest_headline) -- after phase 8: one attested chunk of the
                headline makes at most two synchronising calls (the chunk's
                transfer and the chain's one batched transfer).

13. pool_headline (in a background thread from phase 3 on, beside
                dispatch_rung2 in another, printed before phase 5; neither
                times anything the other phases compare) -- `python -m
                primesim_tpu_torch sweep` on the headline machine with
                --workers 2 --attest chain --chunk-steps 512 --lease-ttl 5:
                serve_headline.json's elements 0, 1 and 7 (1536, 1536 and
                1024 steps) as units, leased to two `worker` processes that
                share the card, with PRIMETPU_POOL_CRASH=w0:1 (worker w0
                kills itself after its first checkpointed chunk). Fails
                unless the victim's unit was re-leased and resumed with
                resumed_steps > 0, the pool report shows the expiry and a
                redispatch, every element's instructions, max core cycles
                and chain head equal the fixture's, every worker's stderr
                names the card, and the surviving workers launched each
                step kernel once per step they ran (router_cascade never).
                Prints the wall, the checkpoint seconds and the unit walls.
   dispatch_rung2 -- `serve configs/rung2_256core_parsec.json --pool-dir D
                --workers 2 --attest chain --audit-rate 1.0 --chunk-steps
                64`: serve_rung2.json's four jobs submitted at once, run by
                an autoscaled pool of two `worker` processes behind a
                spawned `coordinator`. Fails unless every served result
                (steps, per-core cycles, counters) gives the fixture's
                digest and chain head, the coordinator counts 4 audits and
                4 passed, and the workers ran on the card (each step kernel
                at least twice per job step: every unit is run again by its
                audit).
   audit_pool (in pool_headline's thread, after it) -- the resumed unit's
                first unit checkpoint (copied aside as it landed; the
                coordinator reaps unit checkpoints at each ack) put back
                into pool_headline's directory, then `fsck DIR` (clean,
                the checkpoint among what it checked) and `audit DIR` on
                the card: every unit `ok` with its acked head confirmed,
                the replayed heads the fixture's, the checkpoint a prefix
                of its unit's replay, each step kernel launched as often
                as the others and at least once per replayed step
                (router_cascade never). Prints the fsck's and the audit's
                walls, each replay's wall and the launches.
   replicated_headline (in a third background thread from phase 3 on,
                printed before phase 5) -- two `replica` daemons (`--tcp
                127.0.0.1:0`), a primary `serve` on the headline machine
                with `--replicas` both (serve_headline's bucket, chunk
                512, --attest chain) and a standby `serve --standby-of
                PRIMARY --takeover-grace 1.0`. serve_headline's three jobs
                go to the primary; once both replicas' chains hold the
                three accepts and the primary has run a chunk, it is
                killed (SIGKILL) and its state directory deleted. Fails
                unless the standby promotes at a higher epoch, reruns the
                jobs to results and chain heads equal to
                fixtures/serve_headline.json's, launches each step kernel
                once per fleet step and exits 0 on a drain, `fsck
                --compare` of its journal against each replica's and
                `fsck` of its state directory are clean, and the replicas
                exit 0 on SIGTERM. Prints the takeover wall (kill to
                PROMOTING), the frames shipped and acked, the jobs' wall
                and the launches.
   pipeline_rung5 (in phase 11, after stream_rung5) -- ingest/pipeline.py's
                run_pipelined on rung 5 at full geometry over
                stream_rung5's file: 128-event windows filled from 256-event
                segments that two ingest `worker` processes write ahead.
                Fails unless the digest equals stream_rung5.json's (720
                steps, 29 windows) and each step kernel launched once per
                step; prints the segments, the stalls and the wall beside
                stream_rung5's.

14. calibrate_rung1 (in a background thread from phase 3 on, beside the
                next four in another; printed before phase 5; they time
                nothing another phase compares) -- `python -m
                primesim_tpu_torch calibrate configs/rung1_64core_fft.json
                --table configs/calib_ipu_microbench.json --rounds 6 --out
                F`: the default six fit keys, every candidate set a B = 20
                fleet, 37 dispatches (the verb's 24 rounds, 145 dispatches,
                took 308 s, and 10 rounds, 61, up to 289 s of process
                beside the other children: the round cap is the
                fixture's).
                Fails unless every calibrate_residual line and
                calibrate_fit's knobs, start, cost, rounds, fleet_runs and
                batch equal the JAX fit's (fixtures/calib_rung1.json), the
                --out report equals it float for float, and each step kernel
                launched once per fleet step of the fit (router_cascade
                never). Prints the fit's wall, dispatches, fleet steps and
                MIPS.
   calibrate_zoo_selftest -- `calibrate
                configs/zoo_smoke_16core_torus_moesi.json --table ...
                --selftest --truth llc_lat=16,dram_lat=151 --fit
                llc_lat,dram_lat`: exit 0, recovered, and the same checks
                against fixtures/calib_zoo_selftest.json.
   calib_ipu_matrix -- (`chip_smoke.py --child calib_ipu_matrix`, a
                process of its own) the calibrate evaluator at the widest
                shipped machine: the table's four entries at the 1472-tile
                IPU profile's own knobs as one B = 4 fleet (sharer_reductions'
                torus mode batched), equal to the JAX simulate_matrix
                (fixtures/calib_ipu_matrix.json), each step kernel once per
                fleet step.
   chaos_rung2 -- `chaos --config configs/rung2_256core_parsec.json
                --trials 6 --seed 900 --classes durable,crashpoint
                --verbose`: exit 0, the report (trials, fired events, ok,
                classes, seed0) and every per-trial line (seed, ok, fired,
                restarts) equal to the JAX campaign's
                (fixtures/chaos_rung2.json), the step kernels launched.
   chaos_classes -- (`--child chaos_classes`) the campaign's golden run
                on the card equal to JAX's golden_run, then one trial of
                each opt-in class at its fixture seed: socket (a real
                server and a reconnecting client), replication (primary,
                two replicas, a promoted standby), silent_corruption (the
                attested pool: no corrupted unit ends DONE) and
                capacity_loss (a disk-only plan whose fired events equal
                JAX's). Fails unless each plan is JAX's, each trial is ok
                with an event fired, and the step kernels launched.

15. cache_cold (in a third background thread from phase 3 on, beside the
                others; printed before phase 5; child processes that time
                nothing another phase compares) -- `python -m
                primesim_tpu_torch run configs/rung2_256core_parsec.json
                --synth <serve_rung2.json's first job> --fold --chunk-steps
                64 --attest chain --exec-cache on` on a fresh
                PRIMETPU_CACHE_DIR: the kernel build cache misses all four
                kernels (nvcc builds them into the cache, not into
                _build/). Fails unless its exec_cache line shows 4 misses,
                0 hits and no warning, the summary's instructions,
                max_core_cycles, noc_msgs and steps equal the job's JAX
                digest and its chain equals the JAX chain, and each step
                kernel launched once per step. Prints its
                time_to_first_step and exec_cache lines.
   cache_warm -- the same command again on the same directory: 4 hits, 0
                misses, 0.0 s of nvcc, the same checks.
   overlap_fleet -- `sweep` of serve_rung2's four jobs (their traces and
                overrides: a B = 4 fleet) with `--overlap on --exec-cache
                on`, supervised with one final snapshot: 4 hits; each
                element's digest from the snapshot equals its job's JAX
                digest; each step kernel launched once per fleet step.
   overlap_supervised -- (`chip_smoke.py --child overlap_supervised`) the
                first job under RunSupervisor with a snapshot after every
                chunk of 64 and a chain, its third attempt failing after
                its chunk ran on the card (one rollback), once without and
                once with overlapped dispatch, in one process: every
                snapshot of the overlap run equal, array for array, to
                the plain run's, the chain heads after every chunk equal,
                the chain and the digest equal the job's JAX ones, and
                each step kernel launched once per enqueued step
                (speculated chunks, the discarded one included). Prints
                both walls, each snapshot's save seconds, and for each
                snapshot under overlap whether the speculated chunk was
                still running when the snapshot began and after its first
                read of the committed state; then three chunks whose
                speculation ends in a ~50 ms device sleep on its stream,
                with the time of a read of the committed state while it
                runs, against the same read behind the same sleep on the
                current stream.

16. sharded_headline (after reduced_faults, before the join: it runs
                beside the background threads; it checks parity, not speed)
                -- the headline machine on a tile mesh of SHARDS = 4 shards,
                all on cuda:0 (`--devices 4` on one card is a
                DeviceMeshError, as in JAX), through the Python API, to
                step 512 in chunks of 64: each step kernel launched 4
                times a step (one per core shard: the staged-rows probe,
                the delta-row commit, the reductions on a 256-lane block),
                router_cascade never; the digest equal to the JAX
                package's at step 512 (fixtures/sharded_headline_cut.json)
                and to the unsharded port's run to 512 in this call.
                Prints the launches a step, the bytes a step of each
                named cross-shard move (parallel.sharding.MOVES: the
                directory rows staged in, the delta rows out), the peak
                device memory and the wall beside the unsharded run's.
                Each mode's shard-0 inputs of step 300 are kept; after
                phase 5 (its timing helpers) each is held to its plain
                version, timed alone by events and bounded (a "mode"
                line, path sharded_headline). Then 64 more steps under
                CUDA's sync debug mode: the phase fails on any
                synchronising call.
   sharded_rung3 -- rung 3 likewise to step 256
                (fixtures/sharded_rung3_cut.json): router_cascade once a
                step over every shard's legs.
   reshard_rung2 -- configs/rung2_256core_parsec.json on 4 shards (four
                virtual device ids on the card) under RunSupervisor with a
                snapshot every chunk of 128; a chaos plan revokes one shard
                at the second chunk boundary: the run reshards 4 -> 2 from
                the snapshot at step 128 (degrade_rungs "reshard:4->2") and
                finishes with fixtures/rung2_full.json's digest but for its
                steps (chunks of 128 end before 512's); each step kernel
                launched 4 times a step before, 2 after. Prints the
                supervisor's log.

Then a line of every phase's elapsed seconds ("phase_times"), the kernel
summary line (each kernel's batched figures under "batched", the launches
of every path under "launches_by_path") and, last, the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
    "probe_classify": ["full map", "coarse (logG > 0: group bits, epoch guard)",
                       "staged rows (staged = 1: a core shard)"],
    "commit_step": ["MESI", "MOESI (moesi = 1)", "group words (logG > 0)",
                    "delta rows (rows_mode = 1: a core shard)"],
    "sharer_reductions": ["full map", "group (logG > 0)",
                          "mesh, torus, ring (topology = 0, 1, 2)",
                          "a block of the lanes (C < CT: a core shard)"],
    "router_cascade": ["2 legs", "3 legs (has_sync)"],
}
# argument positions of what a kernel updates in place: commit_step's l1,
# dirm and counters, router_cascade's link_free_out
INPLACE = {"commit_step": (0, 1, 9), "router_cascade": (12,),
           "commit_step_rows": (0, 8)}
# argument position of the core ids, which a batch of elements shares
SHARED_ARG = {"probe_classify": 4, "commit_step": 7, "sharer_reductions": 6}
# (link, router) latency of each element in the batched kernels phase:
# eight for the headline's shapes, the first four at rung 3's
FLEET_LATS = [(1, 1), (2, 2), (3, 1), (1, 3), (4, 2), (2, 5), (5, 1), (3, 3)]
FLEET_RUNG3_B = 4
# the fleet paths: the fleet step whose batched kernel inputs are staged
# and timed (the first step after each profiled window), rung 3's
# checkpoint step, and the steps of each fleet_scaling run
FLEET_STAGE = {"fleet_headline": 192, "fleet_rung3": 320}
FLEET_CUT = 512
# fleet_rung3's depth: run to FLEET_CUT, checkpointed, resumed, run to here
# and held to the JAX digests at this depth (fixtures/fleet_rung3_cut.json;
# 1536 until PR 14, with the checkpoint at 1024)
FLEET_DEPTH = 1024
FLEET_SCALE_STEPS = 128
RUNG3_STAGED = ("router_cascade",)  # staged from rung 3, the rest from the headline
# steps of each main path run on the card to stage steps 1 and 300, and
# the first of them that the CPU repeats, where the card is also held
# to a JAX digest (fixtures/headline_cut.json, rung3_headline_cut.json)
CHECK_STEPS = 320
CHECK_CPU_STEPS = 64
PROF_REPS = 10  # profiled launches of each kernel alone
CAPTURE = {"headline": (1, 300), "rung3": (1, 300)}
# the full-geometry large-core paths and the zoo's main paths: (path,
# fixture); the profile window of each but zoo_smoke covers steps 256-319
# and their kernels are staged at the busiest of steps 320-383 (a "mode"
# line: rung 4's 128-word full map, rung 5's group mode, the IPU's torus
# mode, the headline's MOESI commit)
LARGE = (("rung4", "rung4_full"), ("rung5", "rung5_full"))
ZOO = (("zoo_smoke", "zoo_smoke"), ("ipu", "ipu_full"),
       ("headline_moesi", "headline_moesi"))
MODE_PATHS = ("rung4", "rung5", "ipu", "headline_moesi")
# main paths run to a cut depth, held to the JAX digest there: path ->
# (cut fixture, steps)
MAIN_CUT = {"rung3": ("rung3_headline_cut1024", 1024), "ipu": ("ipu_cut", 1024)}
FAULT_COUNTERS = ("core_failstops", "noc_reroutes", "ecc_corrected", "ecc_due")
# the reduced fault machines (256 cores, 16x16): (step, core) of the torus's
# kill while 214 other cores wait at a barrier, and (step, core, lock slot)
# of the ring's kill of a lock holder, both found from CPU dry runs of the
# port (the phase checks both premises on the card)
TORUS_KILL = (64, 138)
RING_KILL = (256, 206, 0)
# the reduced ring machines whose sharer_reductions (ring mode) is staged,
# timed and bounded: (machine, first step of the staged chunk)
RING_MODES = (("ring_stride", 0), ("ring_faults", 256))
# the two longest reduced runs, repeated on the CPU to these steps only
# (the card runs them to the end; the ring's past its kill of the lock
# holder at step 256)
CPU_DEPTH = {"ring_faults": 384, "torus_moesi": 384}
MP_CUT = 1024  # the multiprogrammed path's checkpoint step
# its depth: held to the JAX digest there (fixtures/multiprog_rung3_cut.json),
# snapshotted, and finished by the CLI from that snapshot (cli_multiprog)
MP_DEPTH = 1536
# supervised_faults: its chunk, and the committed chunk whose SIGTERM
# preempts it (step 512 of the faulted headline)
SUP_CHUNK = 256
SUP_KILL_CHUNK = 2
# the resumed run is preempted again after this committed chunk and held to
# the JAX chain head there
SUP_STOP_CHUNK = 3
FORK_PREFIX = 1024  # fleet_fork's shared prefix: its schedule's first event
# fleet_fork and fleet_fork_warm run this many steps after the fork and are
# held to the JAX digests there (fixtures/fleet_fork_cut.json; fleet_fork
# ran on to the end until PR 14)
FORK_CHECK = 512
# attest_headline's depth: one chunk of 512, its head held to the JAX
# run's
ATTEST_DEPTH = 512
# cli_supervised: rung 1's trace (64 steps, four chunks of 16) and the
# sweep's rates-0 schedule, whose first event (step 40) puts the fork at 32
CLI_SUP_SPEC = "fft_like:n_phases=2,points_per_core=64"
CLI_SUP_SCHEDULE = {"events": [{"step": 40, "kind": "link_degrade", "link": 5, "extra": 3}]}
# steps of the multiprogrammed path searched for router_cascade's busiest
# barrier-arrival step (the staged "mode" of its three legs)
MP_STAGE_STEPS = 512
# the streamed paths: the headline through 256-event windows and rung 5
# through 128-event windows (each window one [C, W + 1, 4] int32 upload),
# the CLI's supervised stream on rung 1 through 64-event windows, preempted
# at its third committed window, and the online capture's ocean_like
# arguments (4 worker threads and the main thread: 5 cores; its machine's
# quantum is 100,000 cycles: where the shim reads the hardware's
# instruction counters, a thread's work between two events runs to
# millions of instructions)
STREAM_W = {"stream_headline": 256, "stream_rung5": 128}
CLI_STREAM_W, CLI_STREAM_KILL = 64, 3
OCEAN_ARGS = ("4", "2", "2")
# the served and pooled headline paths' jobs: elements of
# serve_headline.json (serve_headline leaves out element 2, whose 2560
# steps would set its fleet's depth: 1536 fleet steps, not 2560);
# pool_headline's chaos kill (worker w0 after its first checkpointed
# chunk) and lease TTL; pipeline_rung5's ingest segments (events per
# core) and ingest workers
SERVE_ELEMENTS = (0, 1, 7)
POOL_CRASH, POOL_TTL = "w0:1", 5
PIPE_SEG, PIPE_WORKERS = 256, 2
# phase 15: the serve_rung2 job the cache and supervised overlap paths run
# (rung 2, 384 steps in chunks of 64), and the supervised attempt that
# fails after its chunk ran (one rollback)
CACHE_JOB = 0
OVERLAP_FAIL_CALL = 3
# a device sleep (~50 ms at the H100's 1.98 GHz) that holds a speculated
# chunk on the card while a read of the committed state is timed
HELD_SLEEP_CYCLES = 100_000_000
# phase 16, the sharded machine: shards of the tile mesh (all on this
# card), the depths of the sharded headline and rung 3 (held to
# fixtures/sharded_headline_cut.json and sharded_rung3_cut.json, chunks of
# 64), the headline step whose shard-0 kernel inputs are staged and timed
# in the new modes, and reshard_rung2's chunk and the chunk boundary at
# whose arrival one shard is revoked (the second: a snapshot at step 128)
SHARDS = 4
SHARD_DEPTH = {"sharded_headline": 512, "sharded_rung3": 256}
SHARD_STAGE = 300
RESHARD_CHUNK, RESHARD_AT = 128, 2
# the kernels' launch modes on a core shard, held to their plain versions
# and timed alone in phase 16's "mode" line
SHARD_MODES = {"probe_classify": "probe_classify_staged",
               "commit_step": "commit_step_rows",
               "sharer_reductions": "sharer_reductions"}


# operators the profiler drops before it builds its operator tree
PROFILER_SKIPS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def ops_by_shape(cpu_ev, gpu_ev, demangle) -> list:
    """[name, input shapes, self device µs, calls] of every operator with
    device time, by name and input shapes, from the profiler's raw events:
    what `key_averages(group_by_input_shape=True)` gives without the
    profiler's parse into an EventList, which takes tens of seconds a
    window. As that parse does: a kernel counts to the operator whose
    correlation id it links to, a runtime call sits on its operator's
    thread, operators nest by time per thread, and an only child of its
    parent's name merges into the parent with its kernels."""
    gpu_us: dict[int, float] = {}
    for e in gpu_ev:
        c = e.linked_correlation_id()
        if c > 0:
            gpu_us[c] = gpu_us.get(c, 0.0) + (e.end_ns() - e.start_ns()) / 1e3
    evs = [e for e in cpu_ev if e.name() not in PROFILER_SKIPS and not e.is_async()
           and e.start_thread_id() == e.end_thread_id()]
    front = {e.correlation_id(): e.start_thread_id() for e in evs
             if e.linked_correlation_id() == 0}
    node = []  # [name, shapes, thread, start, end, µs, parent, children]
    for e in evs:
        c = e.linked_correlation_id()
        node.append([demangle(e.name()), str(e.shapes()),
                     front.get(c, e.start_thread_id()) if c > 0 else e.start_thread_id(),
                     e.start_ns(), e.end_ns(),
                     gpu_us.get(e.correlation_id(), 0.0) if c == 0 else 0.0, None, []])
    order = sorted(range(len(node)), key=lambda i: (node[i][2], node[i][3], -node[i][4]))
    stack: list[int] = []
    for i in order:
        while stack and (node[stack[-1]][2] != node[i][2] or node[i][3] >= node[stack[-1]][4]
                         or node[i][4] > node[stack[-1]][4]):
            stack.pop()
        if stack:
            node[i][6] = stack[-1]
            node[stack[-1]][7].append(i)
        stack.append(i)
    merged = set()
    for i in order:  # parents first: a chain of only children folds to its top
        p = node[i][6]
        if p is not None and node[p][0] == node[i][0] and len(node[p][7]) == 1:
            node[p][5] = node[i][5]  # the kernels lift up
            node[p][7] = node[i][7]
            for ch in node[i][7]:
                node[ch][6] = p
            merged.add(i)
    groups: dict[tuple, list] = {}
    for i, n in enumerate(node):
        if i not in merged:
            g = groups.setdefault((n[0], n[1]), [0.0, 0])
            g[0] += n[5]
            g[1] += 1
    return sorted(([n, sh[:100], us, c] for (n, sh), (us, c) in groups.items() if us > 0),
                  key=lambda o: -o[2])


def cli_side_by_side(args: list[str], env: dict | None = None) -> dict:
    """`python -m primesim_tpu_torch <args> --device D` on the card and on
    the CPU at once, "{device}" in an argument (and in a value of the
    extra environment `env`) replaced by D: {device: (returncode, stdout,
    stderr)}. A run still going on the way out (a timeout) is killed."""
    procs = {d: subprocess.Popen(
        [sys.executable, "-m", "primesim_tpu_torch",
         *[a.replace("{device}", d) for a in args], "--device", d], cwd=ROOT,
        env={**os.environ, **{k: v.replace("{device}", d) for k, v in (env or {}).items()}},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for d in ("cuda", "cpu")}
    try:
        outs = {d: r.communicate(timeout=600) for d, r in procs.items()}
        return {d: (procs[d].returncode, *outs[d]) for d in procs}
    finally:
        for r in procs.values():
            if r.poll() is None:
                r.kill()
                r.wait()


T0 = time.perf_counter()


PHASE_TIMES: list = []  # [phase, path, elapsed s] of every phase line


def emit(obj) -> None:
    """One JSON line; a phase line gets the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
        PHASE_TIMES.append([obj["phase"], obj.get("path"), obj["t_s"]])
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def load_fixture(name):
    """A committed JAX reference: (its record, machine, trace)."""
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.trace.format import fold_ins, multiplex

    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", f"{name}.json")) as f:
        fx = json.load(f)
    spec = fx["config"]
    if isinstance(spec, str):
        with open(os.path.join(ROOT, spec)) as f:
            spec = json.load(f)
    mcfg, ts = MachineConfig.from_dict(spec), fx["trace"]
    if "multiplex" in ts:  # programs multiplexed into one machine
        tr = multiplex([synth.GENERATORS[p["generator"]](**p["args"])
                        for p in ts["multiplex"]], line_bits=mcfg.line_bits)
    else:
        tr = synth.GENERATORS[ts["generator"]](**ts["args"])
    return fx, mcfg, fold_ins(tr) if ts.get("fold") else tr


def load_cut(name, steps: int):
    """A committed JAX digest at a cut depth (tests/test_torch_rules.py::
    CUT_SPECS): its record, checked to be at `steps`."""
    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", f"{name}.json")) as f:
        fx = json.load(f)
    if fx["steps"] != steps:
        fail(f"{name}: the fixture's depth is {fx['steps']} steps, not {steps}")
    return fx


def load_fleet_fixture(name, made: dict):
    """A committed fleet reference: (its record, machine, each element's
    trace, each element's overrides). `made` maps a trace spec (JSON,
    sorted keys) to a trace already made; new ones are added to it."""
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.trace.format import fold_ins

    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", f"{name}.json")) as f:
        ffx = json.load(f)
    spec = ffx["config"]
    if isinstance(spec, str):
        with open(os.path.join(ROOT, spec)) as f:
            spec = json.load(f)
    trs = []
    for e in ffx["elements"]:
        key = json.dumps(e["trace"], sort_keys=True)
        if key not in made:
            ts = e["trace"]
            tr = synth.GENERATORS[ts["generator"]](**ts["args"])
            made[key] = fold_ins(tr) if ts.get("fold") else tr
        trs.append(made[key])
    return ffx, MachineConfig.from_dict(spec), trs, [e["overrides"] for e in ffx["elements"]]


def stream_phases(dev, smi_line: str, headline, rung5, baselines: dict) -> dict:
    """The streamed and captured paths: stream_headline, stream_rung5,
    stream_snapshot, cli_stream, online and the stream sync_check (module
    docstring). `headline` and `rung5` are the full-width fixtures
    (record, machine, trace), `baselines` the preloaded runs' wall_s and
    peak_memory_bytes by path. Returns each path's launch counts, set to
    0 just before the path was driven."""
    import contextlib
    import gc
    import io
    import signal

    import torch

    from primesim_tpu_torch import cli as tcli
    from primesim_tpu_torch import convert
    from primesim_tpu_torch.config.machine import CacheConfig, MachineConfig, NocConfig
    from primesim_tpu_torch.ingest import capture, ring
    from primesim_tpu_torch.ingest.pipeline import run_pipelined
    from primesim_tpu_torch.ingest.stream import FAULTS_REFUSED, StreamEngine
    from primesim_tpu_torch.kernels import build
    from primesim_tpu_torch.obs import Recorder
    from primesim_tpu_torch.sim import supervisor
    from primesim_tpu_torch.sim.engine import Engine, window_chunk
    from primesim_tpu_torch.stats.digest import run_digest
    from primesim_tpu_torch.trace.format import Trace

    launches = {}
    relative = ("ptr", "cycles", "quantum_end", "barrier_time", "step", "link_free", "dram_free")

    def reset_launches():
        build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))

    def check_launches(path, n_steps, ran=STEP_KERNELS):
        for k, n in launches[path].items():
            if n != (n_steps if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {n_steps} steps")

    def digest(eng):
        return {**run_digest(eng.steps_run, eng.cycles, eng.counters,
                             eng.state.link_free.cpu().numpy(),
                             eng.state.dram_free.cpu().numpy()),
                "windows": len(eng.window_chunks)}

    def against(path, got, stream_fx, full_fx):
        """Fail unless the digest equals the JAX stream digest (steps and
        windows included) where one is committed, and the preloaded JAX
        digest in every field but the chunk-rounded steps."""
        for k, want in full_fx["digest"].items():
            if k != "steps" and got[k] != want:
                fail(f"{path}: {k} {got[k]} != the preloaded JAX digest's {want}")
        if stream_fx is not None:
            for k, want in stream_fx["digest"].items():
                if got[k] != want:
                    fail(f"{path}: {k} {got[k]} != the JAX stream digest's {want}")

    def stream_fixture(name):
        p = os.path.join(ROOT, "primesim_tpu_torch", "fixtures", f"{name}.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        # ---- stream_headline and stream_rung5: each trace written as a
        # PTPU file, memory-mapped and streamed on the card
        mapped, walls = {}, {}
        for path, (fx, mcfg, tr) in (("stream_headline", headline), ("stream_rung5", rung5)):
            W = STREAM_W[path]
            file = os.path.join(tmp, f"{path}.ptpu")
            tr.save(file)
            mapped[path] = Trace.load(file, mmap=True)
            sfx = stream_fixture(path)
            base = path.removeprefix("stream_")  # the preloaded path
            gc.collect()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            eng = StreamEngine(mcfg, mapped[path], window_events=W, device=dev)
            eng.warmup()
            Recorder("basic").attach(eng)  # the per-window fill/dispatch/absorb split
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[path] = dict(build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() - held
            got = digest(eng)
            ch = eng.window_chunks
            pre = baselines[base]
            split = {k: float(np.sum([x["phases"][k] for x in eng.obs.store.samples()]))
                     for k in ("fill", "dispatch", "absorb")}
            window_bytes = mcfg.n_cores * (W + 1) * 4 * 4
            emit({"phase": path, "window_events": W, "windows": len(ch),
                  "chunks_per_window": {"min": int(min(ch)), "median": float(np.median(ch)),
                                        "max": int(max(ch)), "total": int(sum(ch))},
                  "steps": eng.steps_run, "wall_s": wall,
                  "simulated_mips": got["instructions"] / wall / 1e6,
                  "preloaded_wall_s": pre["wall_s"],
                  "wall_over_preloaded": wall / pre["wall_s"],
                  "peak_memory_bytes": peak, "preloaded_peak_memory_bytes": pre["peak_memory_bytes"],
                  "window_upload_bytes": window_bytes, "phase_s": split,
                  "trace_bytes": int(tr.events.nbytes),
                  "launches": launches[path], "instructions": got["instructions"],
                  "digest": {k: v for k, v in got.items() if k.endswith("sha256")},
                  "jax_stream_digest": "committed" if sfx else "not committed: "
                  "checked against the preloaded digest without steps",
                  "equals_jax_digest": sfx is not None and got == sfx["digest"],
                  "gpu": smi_line})
            check_launches(path, eng.steps_run)
            against(path, got, sfx, fx)
            if not eng.done() or got["instructions"] != tr.total_instructions():
                fail(f"{path}: {got['instructions']} instructions retired, "
                     f"trace has {tr.total_instructions()}")
            if path == "stream_headline":
                hs = got
            walls[path] = wall
            del eng
            torch.cuda.empty_cache()
        del mapped["stream_rung5"]

        # ---- pipeline_rung5: rung 5 streamed as stream_rung5, its windows
        # filled from segments that ingest worker processes write ahead
        fx, mcfg, tr = rung5
        file, W = os.path.join(tmp, "stream_rung5.ptpu"), STREAM_W["stream_rung5"]
        sfx = stream_fixture("stream_rung5")
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        t0 = time.perf_counter()
        eng, sup, ing = run_pipelined(
            mcfg, Trace.load(file, mmap=True), trace_path=file, window_events=W,
            seg_events=PIPE_SEG, ingest_workers=PIPE_WORKERS,
            pool_dir=os.path.join(tmp, "ingest_pool"), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["pipeline_rung5"] = dict(build.LAUNCHES)
        got = digest(eng)
        emit({"phase": "pipeline_rung5", "window_events": W, "seg_events": ing["seg_events"],
              "ingest_workers": PIPE_WORKERS, "segments": ing["segments"],
              "segments_preingested": ing["segments_preingested"],
              "pipeline_stalls": ing["pipeline_stalls"], "pool": ing["pool"],
              "windows": got["windows"], "steps": eng.steps_run, "wall_s": wall,
              "stream_rung5_wall_s": walls["stream_rung5"],
              "wall_over_stream": wall / walls["stream_rung5"],
              "supervisor": sup.summary(), "launches": launches["pipeline_rung5"],
              "equals_jax_digest": got == sfx["digest"], "gpu": smi_line})
        check_launches("pipeline_rung5", eng.steps_run)
        against("pipeline_rung5", got, sfx, fx)
        if ing["segments"] < 2 or ing["segments_preingested"]:
            fail(f"pipeline_rung5: {ing['segments']} segments, "
                 f"{ing['segments_preingested']} ingested before the run")
        del eng, sup
        torch.cuda.empty_cache()

        # ---- stream_snapshot: the streamed headline cut at about half its
        # events, saved, resumed in a fresh engine and finished
        fx, mcfg, tr = headline
        W = STREAM_W["stream_headline"]
        eng = StreamEngine(mcfg, mapped["stream_headline"], window_events=W, device=dev)
        reset_launches()
        half = int(eng.real_len.sum()) // 2
        eng.run_events(half)
        cut_events, cut_steps = int(eng.cursor.sum()), eng.steps_run
        snap = os.path.join(tmp, "stream.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save_checkpoint(snap)
        save_s = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        eng = StreamEngine(mcfg, mapped["stream_headline"], window_events=W, device=dev)
        t0 = time.perf_counter()
        eng.load_checkpoint(snap)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        eng.run()
        torch.cuda.synchronize()
        launches["stream_snapshot"] = dict(build.LAUNCHES)
        got = digest(eng)
        got["windows"] = hs["windows"]  # the resumed engine counts its own windows only
        emit({"phase": "stream_snapshot", "cut_events": cut_events, "cut_steps": cut_steps,
              "snapshot_bytes": os.path.getsize(snap), "save_s": save_s, "load_s": load_s,
              "steps": eng.steps_run, "windows_after_resume": len(eng.window_chunks),
              "launches": launches["stream_snapshot"],
              "equals_stream_headline": got == hs, "gpu": smi_line})
        if got != hs:
            fail(f"stream_snapshot: the resumed digest {got} != the streamed headline's {hs}")
        check_launches("stream_snapshot", eng.steps_run)
        del eng
        torch.cuda.empty_cache()

        # ---- the stream sync_check: one window chunk (its drain and a
        # rebase included) makes one synchronising call, its transfer
        eng = StreamEngine(mcfg, mapped["stream_headline"], window_events=W, device=dev)
        buf, exhausted, filled = eng._fill_window()
        events = torch.from_numpy(buf).to(dev)
        ex_dev = torch.from_numpy(exhausted).to(dev)
        st = eng.state._replace(ptr=torch.zeros(mcfg.n_cores, dtype=torch.int32, device=dev))
        n = int(min(64, (filled[~exhausted] // (mcfg.local_run_len + 1)).min(initial=64)))
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                window_chunk(mcfg, events, st, n, True, ex_dev, eng.has_sync)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message)[:200] for w in caught if "synchroniz" in str(w.message)
                 and "prototype feature" not in str(w.message)]
        emit({"phase": "sync_check", "path": "stream_headline", "chunk_steps": n,
              "synchronising_calls": syncs})
        if len(syncs) != 1:
            fail(f"sync_check: a window chunk made {len(syncs)} synchronising calls ({syncs[:3]})")
        del eng, events, st, mapped
        torch.cuda.empty_cache()

        # ---- cli_stream: rung 1 through the CLI, streamed from a
        # memory-mapped file under supervision, on the card and on the CPU:
        # uninterrupted, preempted by SIGTERM at a committed window, resumed
        rung1 = os.path.join(tmp, "rung1.ptpu")
        tcli.main(["synth", CLI_SUP_SPEC, "--cores", "64", "--out", rung1, "--fold"])
        base_args = ["run", "configs/rung1_64core_fft.json", "--trace", rung1, "--mmap",
                     "--stream-window", str(CLI_STREAM_W), "--checkpoint-every", "2",
                     "--attest", "chain"]
        real_init = supervisor.RunSupervisor.__init__

        def preempting(self, *a, **kw):
            real_init(self, *a, **kw)

            def on_chunk(sup):
                if sup.committed == CLI_STREAM_KILL:
                    os.kill(os.getpid(), signal.SIGTERM)

            self.on_chunk = on_chunk

        def cli(args, kill=False):
            out = io.StringIO()
            if kill:
                supervisor.RunSupervisor.__init__ = preempting
            try:
                with contextlib.redirect_stdout(out):
                    rc = tcli.main(args)
            finally:
                supervisor.RunSupervisor.__init__ = real_init
            lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
            return rc, lines[-1]

        res = {}
        reset_launches()
        for d in ("cuda", "cpu"):
            ck = [os.path.join(tmp, f"ck_{d}_{i}") for i in (0, 1)]
            res[d] = [cli(base_args + ["--checkpoint-dir", ck[0], "--device", d]),
                      cli(base_args + ["--checkpoint-dir", ck[1], "--device", d], kill=True),
                      cli(base_args + ["--checkpoint-dir", ck[1], "--resume", "--device", d])]
        launches["cli_stream"] = dict(build.LAUNCHES)
        sched = os.path.join(tmp, "failstop.json")
        with open(sched, "w") as f:
            json.dump({"events": [{"step": 5, "kind": "core_failstop", "core": 1}]}, f)
        try:
            tcli.main(["run", "configs/rung1_64core_fft.json", "--trace", rung1,
                       "--stream-window", str(CLI_STREAM_W), "--fault-schedule", sched,
                       "--device", "cuda"])
            refused = None
        except SystemExit as e:
            refused = str(e)

        def detail(line, drop=("wall_s", "device", "resumed_from", "committed_chunks",
                               "checkpoints_written")):
            return {k: v for k, v in line["detail"].items() if k not in drop}

        rcs = {d: [r[0] for r in res[d]] for d in res}
        emit({"phase": "cli_stream", "returncodes": rcs,
              "summary": {k: res["cuda"][0][1]["detail"][k]
                          for k in ("instructions", "max_core_cycles", "noc_msgs", "steps",
                                    "committed_chunks", "checkpoints_written")},
              "preempted": res["cuda"][1][1]["detail"].get("committed_chunks"),
              "resumed_from": os.path.basename(res["cuda"][2][1]["detail"]["resumed_from"] or ""),
              "card_equals_cpu": detail(res["cuda"][0][1]) == detail(res["cpu"][0][1]),
              "resume_equals_run": [detail(res[d][2][1]) == detail(res[d][0][1]) for d in res],
              "attest": res["cuda"][0][1]["detail"].get("attest"),
              "launches": launches["cli_stream"],
              "faults_refusal": refused, "gpu": smi_line})
        if any(r != [0, 75, 0] for r in rcs.values()):
            fail(f"cli_stream: exit codes {rcs}")
        if detail(res["cuda"][0][1]) != detail(res["cpu"][0][1]):
            fail(f"cli_stream: card {res['cuda'][0][1]} != CPU {res['cpu'][0][1]}")
        for d in res:
            if detail(res[d][2][1]) != detail(res[d][0][1]):
                fail(f"cli_stream: the resumed run {res[d][2][1]} != the run {res[d][0][1]}")
        if refused != FAULTS_REFUSED:
            fail(f"cli_stream: faults with --stream-window gave {refused!r}")
        if not res["cuda"][0][1]["detail"].get("attest", {}).get("head"):
            fail(f"cli_stream: no chain in the summary {res['cuda'][0][1]}")
        # the card's preempted run and its resumption together run the
        # uninterrupted run's steps once more
        check_launches("cli_stream", 2 * res["cuda"][0][1]["detail"]["steps"])

        # ---- online: the port's shim and ocean_like captured through the
        # shared-memory rings while OnlineEngine simulates them on the card;
        # then the preloaded Engine on the captured stream, on the card and
        # on the CPU, and `capture --out` simulated on both
        for tool in ("gcc", "g++"):
            if shutil.which(tool) is None:
                fail(f"online: no {tool} on this host")
        binary = os.path.join(tmp, "ocean_like")
        # -U_FORTIFY_SOURCE: a compiler that fortifies by default would call
        # __memcpy_chk, which the shim does not interpose
        subprocess.run(["gcc", "-O2", "-fno-builtin", "-U_FORTIFY_SOURCE", "-o", binary,
                        str(capture.FRONTEND / "examples" / "ocean_like.c"), "-lpthread"],
                       check=True, capture_output=True)
        t0 = time.perf_counter()
        capture.build_shim()
        shim_s = time.perf_counter() - t0
        ocfg = MachineConfig(
            n_cores=int(OCEAN_ARGS[0]) + 1, n_banks=4,
            l1=CacheConfig(size=2048, ways=2, line=64, latency=2),
            llc=CacheConfig(size=16384, ways=4, line=64, latency=10),
            noc=NocConfig(mesh_x=2, mesh_y=2, link_lat=1, router_lat=1),
            dram_lat=100, quantum=100_000)
        proc, src = capture.capture_online([binary, *OCEAN_ARGS], n_cores=ocfg.n_cores, line=64)
        try:
            eng = ring.OnlineEngine(ocfg, src, window_events=256, device=dev)
            eng.warmup()
            reset_launches()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            online_s = time.perf_counter() - t0
            launches["online"] = dict(build.LAUNCHES)
            target_rc = proc.wait(timeout=60)
            dropped, n_events = src.dropped(), int(src.total.sum())
            captured = src.to_trace()
        finally:
            if proc.poll() is None:
                proc.kill()
            src.close()
        pre = {}
        for d in ("cuda", "cpu"):
            pre[d] = Engine(ocfg, captured, chunk_steps=64, device=d)
            pre[d].run()
        t_, r_ = convert.state_to_numpy(eng.state), convert.state_to_numpy(pre["cuda"].state)
        online_equal = np.array_equal(eng.cycles, pre["cuda"].cycles) and all(
            np.array_equal(eng.counters[k], pre["cuda"].counters[k]) for k in eng.counters
        ) and all(np.array_equal(t_[f][k], r_[f][k]) if k else np.array_equal(t_[f], r_[f])
                  for f in set(r_) - set(relative)
                  for k in (r_[f] if isinstance(r_[f], dict) else [None]))
        pre_equal = np.array_equal(pre["cuda"].cycles, pre["cpu"].cycles) and all(
            np.array_equal(pre["cuda"].counters[k], pre["cpu"].counters[k])
            for k in pre["cpu"].counters)
        out_file = os.path.join(tmp, "ocean.ptpu")
        cfg_file = os.path.join(tmp, "ocean.json")
        with open(cfg_file, "w") as f:
            f.write(ocfg.to_json())
        with contextlib.redirect_stderr(io.StringIO()):
            out_rc = tcli.main(["capture", cfg_file, "--out", out_file, binary, *OCEAN_ARGS])
        replay = {d: Engine(ocfg, Trace.load(out_file), chunk_steps=64, device=d)
                  for d in ("cuda", "cpu")}
        for e in replay.values():
            e.run()
        replay_equal = np.array_equal(replay["cuda"].cycles, replay["cpu"].cycles) and all(
            np.array_equal(replay["cuda"].counters[k], replay["cpu"].counters[k])
            for k in replay["cpu"].counters)
        ch = eng.window_chunks
        emit({"phase": "online", "program": ["ocean_like", *OCEAN_ARGS], "cores": ocfg.n_cores,
              "target_rc": target_rc, "events": n_events, "dropped": dropped,
              "steps": eng.steps_run, "windows": len(ch),
              "chunks_per_window": {"min": int(min(ch)), "median": float(np.median(ch)),
                                    "max": int(max(ch))},
              "wall_s": online_s, "shim_build_s": shim_s,
              "barrier_waits": int(eng.counters["barrier_waits"].sum()),
              "lock_acquires": int(eng.counters["lock_acquires"].sum()),
              "online_equals_preloaded_card": online_equal,
              "preloaded_card_equals_cpu": pre_equal,
              "capture_out_rc": out_rc, "capture_out_card_equals_cpu": replay_equal,
              "launches": launches["online"], "gpu": smi_line})
        if target_rc != 0 or dropped or not n_events or out_rc != 0:
            fail(f"online: target exited {target_rc}, {dropped} dropped of {n_events}, "
                 f"capture --out exited {out_rc}")
        if not (online_equal and pre_equal and replay_equal):
            fail(f"online: online == preloaded {online_equal}, card == CPU {pre_equal}, "
                 f"capture --out card == CPU {replay_equal}")
        check_launches("online", eng.steps_run)
        del eng, pre, replay
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def resilience_phases(dev, smi_line: str, hf, made: dict, baseline: dict | None = None) -> dict:
    """The supervised and forked paths: supervised_faults and fleet_fork
    (module docstring). `hf` is the headline_faults
    fixture (record, machine, trace), `made` the traces already made (see
    load_fleet_fixture), `baseline` the unsupervised headline_faults run's
    wall_s and peak_memory_bytes. Returns each path's launch counts, set
    to 0 just before the path was driven."""
    import gc
    import signal

    import torch

    from primesim_tpu_torch.attest import SoloAttest
    from primesim_tpu_torch.kernels import build
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.sim.fleet import FleetEngine
    from primesim_tpu_torch.sim.prefix import execute_prefix_plan, plan_prefix
    from primesim_tpu_torch.sim.state import map_state
    from primesim_tpu_torch.sim.supervisor import Preempted, RunSupervisor
    from primesim_tpu_torch.stats.digest import run_digest

    launches = {}

    def reset_launches():
        build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))

    def check_launches(path, n_steps, ran):
        for k, n in launches[path].items():
            if n != (n_steps if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {n_steps} steps")

    def element_digest(fl, i):
        cnt = fl.counters
        return run_digest(fl.steps_run[i], fl.cycles[i], {k: v[i] for k, v in cnt.items()},
                          fl.state.link_free[i].cpu().numpy(),
                          fl.state.dram_free[i].cpu().numpy())

    # ---- supervised_faults: the faulted headline under RunSupervisor,
    # preempted by SIGTERM at a chunk boundary, resumed in a fresh engine
    # whose first chunk fails after running on the card and is rolled back
    hffx, cfg_hf, trace_hf = hf
    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", "attest_faults.json")) as f:
        atfx = json.load(f)
    if (atfx["config"], atfx["trace"], atfx["chunk_steps"]) != (
            hffx["config"], hffx["trace"], SUP_CHUNK):
        fail("supervised_faults: attest_faults.json names another run than this path's")
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_sup_")
    saves = []

    def supervised(on_chunk=None):
        eng = Engine(cfg_hf, trace_hf, chunk_steps=SUP_CHUNK, device=dev)
        eng.attest = SoloAttest(SUP_CHUNK)  # rolls back and crosses the snapshot with the state
        real_save = eng.save_checkpoint

        def timed_save(path):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real_save(path)
            saves.append(time.perf_counter() - t)

        eng.save_checkpoint = timed_save
        sup = RunSupervisor(eng, snapshot_dir=ck_dir, checkpoint_every_chunks=2,
                            keep_snapshots=2, guard="off", backoff_s=0.01,
                            on_chunk=on_chunk)
        torch.cuda.synchronize()
        return eng, sup

    def preempt_at(n):
        def on_chunk(sup):
            if sup.committed == n:
                os.kill(os.getpid(), signal.SIGTERM)
        return on_chunk

    try:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng, sup = supervised(preempt_at(SUP_KILL_CHUNK))
        reset_launches()
        t0 = time.perf_counter()
        try:
            sup.run()
            fail("supervised_faults: the run was not preempted")
        except Preempted as e:  # its traceback holds the engine: keep the path only
            pre_ckpt = e.checkpoint
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        cut, first = eng.steps_run, sup.summary()
        snap_bytes = os.path.getsize(pre_ckpt)
        del eng, sup
        gc.collect()  # the timed save's wrapper and the engine form a cycle
        torch.cuda.empty_cache()
        eng, sup = supervised(preempt_at(SUP_STOP_CHUNK - SUP_KILL_CHUNK))
        t0 = time.perf_counter()
        resumed = sup.resume()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        chain_at_resume = eng.attest.payload()
        real_steps, failed = eng.run_steps, []

        def fail_once(n):  # the real chunk runs on the card, then it fails
            done = real_steps(n)
            if not failed:
                torch.cuda.synchronize()
                failed.append(eng.steps_run)
                raise RuntimeError("UNAVAILABLE: injected after a real chunk on the card")
            return done

        eng.run_steps = fail_once
        t0 = time.perf_counter()
        try:
            sup.run()
            fail("supervised_faults: the resumed run was not preempted")
        except Preempted:
            pass
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        launches["supervised_faults"] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
        want_chain = {"head": atfx["heads"][SUP_STOP_CHUNK - 1], "chunks": SUP_STOP_CHUNK,
                      "start": 0, "chunk_steps": SUP_CHUNK}
        copy_ms = []  # the rollback copy alone: CUDA events around one copy
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            c = map_state(torch.clone, eng.state)
            b.record()
            torch.cuda.synchronize()
            copy_ms.append(a.elapsed_time(b))
            del c
        second = sup.summary()
        executed = eng.steps_run + SUP_CHUNK  # the failed chunk ran too
        line = {
            "phase": "supervised_faults", "chunk_steps": SUP_CHUNK,
            "preempted_at_step": cut, "preempt_checkpoint": os.path.basename(pre_ckpt),
            "resumed_from": os.path.basename(resumed or ""),
            "failed_chunk_reached_step": failed[0] if failed else None,
            "steps": eng.steps_run, "steps_executed": executed,
            "checkpoints_written": [first["checkpoints_written"], second["checkpoints_written"]],
            "retries": second["retries"], "snapshots_kept": sorted(os.listdir(ck_dir)),
            "snapshot_bytes": snap_bytes, "save_s": saves, "load_s": load_s,
            "rollback_bytes": sup.rollback_bytes, "rollback_copies": sup.rollback_copies,
            "rollback_copy_ms": float(np.median(copy_ms)),
            "wall_s": [wall1, wall2], "wall_total_s": wall1 + wall2,
            "peak_memory_bytes": peak,
            "unsupervised": baseline, "launches": launches["supervised_faults"],
            "attest": eng.attest.payload(), "chain_at_resume": chain_at_resume,
            "attest_equals_jax": eng.attest.payload() == want_chain,
            "resilience_log": sup.log_lines(), "gpu": smi_line}
        emit(line)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    if resumed != pre_ckpt or cut != SUP_KILL_CHUNK * SUP_CHUNK:
        fail(f"supervised_faults: preempted at {cut}, resumed from {resumed}")
    if failed != [cut + SUP_CHUNK] or second["retries"] != 1:
        fail(f"supervised_faults: failed chunk {failed}, retries {second['retries']}")
    # the snapshots every two chunks before the preempted one, and its own
    if first["checkpoints_written"] != (SUP_KILL_CHUNK - 1) // 2 + 1 \
            or second["checkpoints_written"] != 1 \
            or eng.steps_run != SUP_STOP_CHUNK * SUP_CHUNK:
        fail(f"supervised_faults: checkpoints {first}, {second}, stopped at {eng.steps_run}")
    check_launches("supervised_faults", executed, STEP_KERNELS)
    # the chain crossed the snapshot (its head there is the JAX run's after
    # the preempted chunk) and the rolled-back chunk was linked once
    if chain_at_resume["head"] != atfx["heads"][SUP_KILL_CHUNK - 1] \
            or chain_at_resume["chunks"] != SUP_KILL_CHUNK:
        fail(f"supervised_faults: the resumed chain {chain_at_resume} is not the JAX run's "
             f"after chunk {SUP_KILL_CHUNK}")
    if line["attest_equals_jax"] is not True:
        fail(f"supervised_faults: the chain {line['attest']} != the uninterrupted JAX "
             f"run's after chunk {SUP_STOP_CHUNK} {want_chain}")

    # ---- fleet_fork: the headline machine as a B = 4 fleet under a
    # rates-0 schedule; three seed-only elements share a 1024-step prefix,
    # run once and forked; a second fleet takes it from the warm cache
    ffx, fcfg, ftrs, fovs = load_fleet_fixture("fleet_fork", made)
    cut_fx = load_cut("fleet_fork_cut", [FORK_PREFIX + FORK_CHECK] * 3 + [FORK_CHECK])
    cache = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    at_check = None  # fleet_fork's digests FORK_CHECK steps after the fork
    try:
        for path in ("fleet_fork", "fleet_fork_warm"):
            fl = FleetEngine(fcfg, ftrs, fovs, chunk_steps=ffx["chunk_steps"], device=dev)
            groups = plan_prefix(fl.elem_cfgs, fl.traces, chunk_steps=fl.chunk_steps)
            plan = [(g.indices, g.prefix_steps) for g in groups]
            if plan != [([0, 1, 2], FORK_PREFIX)]:
                fail(f"{path}: planned {plan}, not [([0, 1, 2], {FORK_PREFIX})]")
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            st = execute_prefix_plan(fl, groups, warm_cache=True, cache_root=cache)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            start = fl.steps_run.copy()
            fl.run_steps(FORK_CHECK)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches[path] = dict(build.LAUNCHES)
            fleet_steps = int((fl.steps_run - start).max())
            simulated = FORK_PREFIX if st["cache_misses"] else 0
            got = [element_digest(fl, i) for i in range(fl.n_elements)]
            if path == "fleet_fork":  # the warm fleet is held to these digests too
                at_check = got
            warm_bytes = sum(os.path.getsize(os.path.join(cache, n))
                             for n in os.listdir(cache) if n.endswith(".npz"))
            equal = [g == d for g, d in zip(got, cut_fx["digests"])]
            emit({"phase": path, "B": fl.n_elements, "prefix": st,
                  "prefix_steps_simulated": simulated, "fork_and_prefix_s": t1 - t0,
                  "fleet_steps": fleet_steps, "fleet_wall_s": t2 - t1,
                  "steps_by_element": fl.steps_run.tolist(),
                  "prefix_steps_by_element": fl.prefix_steps.tolist(),
                  "warm_entry_bytes": warm_bytes, "launches": launches[path],
                  "equals_jax_digest": equal,
                  "equals_fleet_fork": None if path == "fleet_fork" else got == at_check,
                  "gpu": smi_line})
            want_hits = int(path == "fleet_fork_warm")
            if (st["cache_hits"], st["cache_misses"]) != (want_hits, 1 - want_hits):
                fail(f"{path}: cache hits/misses {st['cache_hits']}/{st['cache_misses']}")
            if want_hits and st["prefix_wall_s"] != 0.0:
                fail(f"{path}: a warm hit simulated its prefix")
            check_launches(path, simulated + fleet_steps, STEP_KERNELS)
            for i, (g, d) in enumerate(zip(got, cut_fx["digests"])):
                for k, want in d.items():
                    if g[k] != want:
                        fail(f"{path}: element {i} {k} {g[k]} != the JAX package's {want} "
                             f"{FORK_CHECK} steps after the fork")
            if path == "fleet_fork_warm" and got != at_check:
                fail(f"{path}: {FORK_CHECK} steps after the warm fork, elements differ "
                     "from fleet_fork's")
            del fl
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    return launches


def cli_supervised_phase() -> list:
    """cli_supervised (module docstring), for a background thread beside
    phases 3 and 4 (child processes only; it times nothing): its phase
    line, for the main thread to print."""
    # ---- cli_supervised: `run` supervised with the guard, then the same
    # command with --resume (a no-op rerun from the final snapshot), and a
    # forked seed sweep run twice against one warm cache; each on the card
    # and on the CPU side by side
    cdir = tempfile.mkdtemp(prefix="chip_smoke_cli_sup_")
    try:
        run = ["run", "configs/rung1_64core_fft.json", "--synth", CLI_SUP_SPEC, "--fold",
               "--chunk-steps", "16", "--checkpoint-dir", os.path.join(cdir, "ck_{device}"),
               "--checkpoint-every", "2", "--guard", "fail", "--attest", "chain"]
        with open(os.path.join(cdir, "sched.json"), "w") as f:
            json.dump(CLI_SUP_SCHEDULE, f)
        sweep = ["sweep", "configs/rung1_64core_fft.json", "--synth", CLI_SUP_SPEC, "--fold",
                 "--fault-schedule", os.path.join(cdir, "sched.json"),
                 "--vary", "fault_seed=1", "--vary", "fault_seed=2", "--vary", "fault_seed=3",
                 "--chunk-steps", "16", "--fork-prefix", "auto", "--warm-cache", "on"]
        env = {"PRIMETPU_CACHE_DIR": os.path.join(cdir, "warm_{device}")}
        # the run chain and the sweep chain at once, each in order
        with ThreadPoolExecutor(2) as pool:
            runs_f = pool.submit(lambda: [cli_side_by_side(run),
                                          cli_side_by_side(run + ["--resume"])])
            sweeps_f = pool.submit(lambda: [cli_side_by_side(sweep, env),
                                            cli_side_by_side(sweep, env)])
            res = runs_f.result() + sweeps_f.result()
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    for r in res:
        if any(x[0] != 0 for x in r.values()):
            fail(f"cli_supervised: exit codes {[x[0] for x in r.values()]}: "
                 f"{r['cuda'][2][-500:]} {r['cpu'][2][-500:]}")

    def lines(out, drop=("wall_s", "device")):
        got = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        for ln in got:
            if ln.get("unit") == "MIPS":
                ln.pop("value")
            for k in drop:
                ln["detail"].pop(k, None)
        return got

    runs = [{d: lines(r[d][1])[-1]["detail"] for d in r} for r in res[:2]]
    for d in runs[1]:
        for k in ("resumed_from", "committed_chunks", "checkpoints_written"):
            runs[1][d].pop(k)
            runs[0][d].pop(k)
    sweeps = [{d: lines(r[d][1], drop=("wall_s", "prefix_wall_s")) for d in r} for r in res[2:]]
    forks = [{d: [ln["detail"] for ln in s[d] if ln["metric"] == "prefix_fork"] for d in s}
             for s in sweeps]
    line = {"phase": "cli_supervised",
          "run_card_equals_cpu": runs[0]["cuda"] == runs[0]["cpu"],
          "resume_equals_run": [runs[1][d] == runs[0][d] for d in ("cuda", "cpu")],
          "instructions": runs[0]["cuda"].get("instructions"),
          "attest": runs[0]["cuda"].get("attest"),
          "sweep_card_equals_cpu": [s["cuda"] == s["cpu"] for s in sweeps],
          "prefix_fork": [f["cuda"] for f in forks]}
    if runs[0]["cuda"] != runs[0]["cpu"] or any(runs[1][d] != runs[0][d] for d in runs[1]):
        fail(f"cli_supervised: run lines differ: {runs}")
    if not runs[0]["cuda"].get("attest", {}).get("head"):
        fail(f"cli_supervised: no chain in the summary {runs[0]['cuda']}")
    for s, f, hits in zip(sweeps, forks, (0, 1)):
        if s["cuda"] != s["cpu"] or [x.get("cache_hits") for x in f["cuda"]] != [hits]:
            fail(f"cli_supervised: sweep lines {s}")
    return [line]


def spawn_daemon(args: list[str], env: dict | None = None):
    """`python -m primesim_tpu_torch serve ...` on the card as a child
    process: (the process, its socket) once a health round trip answers.
    Fails if it exits first or is not ready within 300 s."""
    from primesim_tpu_torch.serve.client import ServeClient

    sock = os.path.join(args[args.index("--state-dir") + 1], "serve.sock")
    proc = subprocess.Popen([sys.executable, "-m", "primesim_tpu_torch", *args], cwd=ROOT,
                            env={**os.environ, **(env or {})}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    probe, deadline = ServeClient(sock, timeout_s=5.0), time.time() + 300
    while True:
        if proc.poll() is not None:
            fail(f"serve: the daemon exited {proc.returncode} at startup: "
                 f"{proc.stderr.read()[-1000:]}")
        if os.path.exists(sock):
            try:
                probe.health()
                return proc, sock
            except OSError:
                pass
        if time.time() > deadline:
            proc.kill()
            fail("serve: the daemon never answered")
        time.sleep(0.05)


def attest_serve_phases(dev, smi_line: str, headline, baselines: dict, made: dict) -> dict:
    """The attested and served paths: attest_headline and serve_headline
    (module docstring). `headline` is the headline fixture
    (record, machine, trace), `baselines` the preloaded runs' wall_s and
    peak_memory_bytes by path, `made` the traces already made (see
    load_fleet_fixture). Returns each path's launch counts, set to 0 just
    before the path was driven (a daemon's: its process's, from 0)."""
    import torch

    from primesim_tpu_torch.attest import SoloAttest
    from primesim_tpu_torch.kernels import build
    from primesim_tpu_torch.serve.client import ServeClient
    from primesim_tpu_torch.serve.scheduler import PAGE_EVENTS
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.stats.digest import run_digest
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.trace.format import fold_ins

    launches = {}

    def served(result):
        """A result record's digest: the fixture digest's fields but the
        link and controller clocks, which a result does not carry."""
        d = run_digest(result["steps"], result["core_cycles"],
                       {k: np.asarray(v) for k, v in result["counters"].items()}, [], [])
        return {k: v for k, v in d.items() if k not in ("link_free_sha256", "dram_free_sha256")}

    def check_daemon_launches(path, dstats, ran=STEP_KERNELS):
        n = dstats["fleet_steps"]
        for k, c in dstats["kernel_launches"].items():
            if c != (n if k in ran else 0):
                fail(f"{path}: {k} launched {c} times in {n} fleet steps")

    # ---- attest_headline: the headline run with a chain, every chunk's
    # head against the JAX package's
    hfx, cfg, trace = headline
    afx = fixture_json("attest_headline")
    if (afx["config"], afx["trace"]) != (hfx["config"], hfx["trace"]):
        fail("attest_headline: the fixture names another machine or trace than the headline's")
    chunk = afx["chunk_steps"]
    held = torch.cuda.memory_allocated()
    eng = Engine(cfg, trace, chunk_steps=chunk, device=dev)
    eng.attest = SoloAttest(chunk)
    per_chunk, observe = [], eng.attest.observe

    def observed(e):
        observe(e)
        per_chunk.append({**eng.attest.stats, "head": eng.attest.payload()["head"]})

    eng.attest.observe = observed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))
    t0 = time.perf_counter()
    eng.run_steps(ATTEST_DEPTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["attest_headline"] = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    got = run_digest(eng.steps_run, eng.cycles, eng.counters,
                     eng.state.link_free.cpu().numpy(), eng.state.dram_free.cpu().numpy())
    heads = [c["head"] for c in per_chunk]
    want_heads = afx["heads"][:ATTEST_DEPTH // chunk]
    want_chain = {"head": want_heads[-1], "chunks": len(want_heads), "start": 0,
                  "chunk_steps": chunk}
    first_bad = next((k + 1 for k, (a, b) in enumerate(zip(heads, want_heads)) if a != b),
                     None)
    emit({"phase": "attest_headline", "chunk_steps": chunk, "steps": eng.steps_run,
          "chunks": len(heads), "wall_s": wall, "simulated_mips": got["instructions"] / wall / 1e6,
          "unattested": baselines["headline"], "unattested_steps": hfx["digest"]["steps"],
          "peak_memory_bytes": peak,
          "bytes_hashed_per_chunk": [c["bytes"] for c in per_chunk],
          "transfer_s_per_chunk": [c["transfer_s"] for c in per_chunk],
          "hash_s_per_chunk": [c["hash_s"] for c in per_chunk],
          "attest": eng.attest.payload(), "heads_equal_jax": first_bad is None
          and len(heads) == len(want_heads), "launches": launches["attest_headline"],
          "gpu": smi_line})
    if len(heads) != len(want_heads) or first_bad is not None:
        fail(f"attest_headline: the chain first differs from the JAX heads at chunk "
             f"{first_bad} ({len(heads)} chunks, the JAX run {len(want_heads)})")
    if eng.attest.payload() != want_chain:
        fail(f"attest_headline: payload {eng.attest.payload()} != the JAX {want_chain}")
    for k, n in launches["attest_headline"].items():
        if n != (eng.steps_run if k in STEP_KERNELS else 0):
            fail(f"attest_headline: {k} launched {n} times in {eng.steps_run} steps")
    del eng
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    procs = []
    try:
        # ---- serve_headline: the daemon through the CLI on the headline
        # machine, one bucket of 3 slots, three of fleet_headline's
        # elements (SERVE_ELEMENTS) submitted through `submit`
        sfx = fixture_json("serve_headline")
        if sfx["config"] != hfx["config"] or sfx["jobs"][0]["attest"] != afx["attest"]:
            fail("serve_headline: the fixture's machine or element 0's chain is not the "
                 "headline's")
        sfx["jobs"] = [e for e in sfx["jobs"] if e["element"] in SERVE_ELEMENTS]
        cfg_path = os.path.join(tmp, "headline.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        specs, job_trs = [], []
        for e in sfx["jobs"]:
            ts = e["trace"]
            specs.append(ts["generator"] + ":" + ",".join(
                f"{k}={v}" for k, v in ts["args"].items() if k != "n_cores"))
            key = json.dumps(ts, sort_keys=True)
            if key not in made:
                tr = synth.GENERATORS[ts["generator"]](**ts["args"])
                made[key] = fold_ins(tr) if ts.get("fold") else tr
            job_trs.append(made[key])
        pages = -(-max(tr.max_len for tr in job_trs) // PAGE_EVENTS)
        schunk = sfx["chunk_steps"]
        proc, sock = spawn_daemon(
            ["serve", cfg_path, "--state-dir", os.path.join(tmp, "headline"),
             "--buckets", f"{len(specs)}x{pages}", "--chunk-steps", str(schunk),
             "--attest", "chain", "--checkpoint-wall", "3600"])
        procs.append(proc)
        t0 = time.perf_counter()
        subs = [subprocess.Popen(
            [sys.executable, "-m", "primesim_tpu_torch", "submit", "--socket", sock,
             "--synth", spec, "--fold",
             *(["--vary", ",".join(f"{k}={v}" for k, v in e["overrides"].items())]
               if e["overrides"] else [])],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for spec, e in zip(specs, sfx["jobs"])]
        ids = []
        for sp in subs:
            out, err = sp.communicate(timeout=600)
            if sp.returncode != 0:
                fail(f"serve_headline: submit exited {sp.returncode}: {out} {err[-500:]}")
            ids.append(json.loads(out.strip().splitlines()[-1])["job"]["job_id"])
        cli = ServeClient(sock, timeout_s=60.0)
        results = [cli.wait(i, timeout_s=900.0) for i in ids]
        jobs_wall = time.perf_counter() - t0
        health = cli.health()
        cli.drain()  # the queue is empty: the daemon exits 0
        out, err = proc.communicate(timeout=600)
        dstats = health["device"]
        launches["serve_headline"] = dstats["kernel_launches"]
        ins = sum(r["result"]["instructions"] for r in results if r["state"] == "DONE")
        same = [r["state"] == "DONE" and served(r["result"]) == e["digest"]
                for r, e in zip(results, sfx["jobs"])]
        chains = [r.get("result", {}).get("attest") == e["attest"]
                  for r, e in zip(results, sfx["jobs"])]
        emit({"phase": "serve_headline", "bucket": f"{len(specs)}x{pages}",
              "capacity_events": pages * PAGE_EVENTS, "chunk_steps": schunk,
              "elements": [e["element"] for e in sfx["jobs"]],
              "job_steps": [r.get("result", {}).get("steps") for r in results],
              "jobs_wall_s": jobs_wall, "aggregate_mips": ins / jobs_wall / 1e6,
              "fleet_steps": dstats["fleet_steps"], "launches": launches["serve_headline"],
              "launches_per_fleet_step": {k: n / max(1, dstats["fleet_steps"])
                                          for k, n in launches["serve_headline"].items()},
              "peak_memory_bytes": dstats.get("peak_memory_bytes"),
              "service": {k: health[k] for k in ("completed", "aggregate_mips", "latency_s")},
              "results_equal_jax": same, "heads_equal_jax": chains,
              "daemon_returncode": proc.returncode, "gpu": smi_line})
        if not all(same) or not all(chains):
            fail(f"serve_headline: results {same}, chain heads {chains} against the JAX runs")
        if proc.returncode != 0:
            fail(f"serve_headline: the daemon exited {proc.returncode}: {err[-500:]}")
        if dstats["fleet_steps"] < max(r["result"]["steps"] for r in results):
            fail(f"serve_headline: {dstats['fleet_steps']} fleet steps for jobs of "
                 f"{[r['result']['steps'] for r in results]}")
        check_daemon_launches("serve_headline", dstats)

    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def serve_recover_phase(smi_line: str):
    """serve_recover (module docstring), for a worker thread beside the
    CLI phases: the daemon on rung 2 killed by a chaos crashpoint after its
    first checkpoint and restarted. Returns (its phase line, its launch
    counts, the failures found), for the main thread to print and judge."""
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.serve import JobJournal, fold_records
    from primesim_tpu_torch.serve.client import ServeClient
    from primesim_tpu_torch.serve.scheduler import PAGE_EVENTS, parse_synth_spec
    from primesim_tpu_torch.stats.digest import run_digest

    def served(result):
        d = run_digest(result["steps"], result["core_cycles"],
                       {k: np.asarray(v) for k, v in result["counters"].items()}, [], [])
        return {k: v for k, v in d.items() if k not in ("link_free_sha256", "dram_free_sha256")}

    problems = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recover_")
    procs = []
    try:
        with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", "serve_rung2.json")) as f:
            rfx = json.load(f)
        with open(os.path.join(ROOT, rfx["config"])) as f:
            rcfg = MachineConfig.from_json(f.read())
        rtrs = [parse_synth_spec(j["synth"], rcfg.n_cores, True) for j in rfx["jobs"]]
        rpages = -(-max(tr.max_len for tr in rtrs) // PAGE_EVENTS)
        plan = os.path.join(tmp, "plan.json")
        with open(plan, "w") as f:
            json.dump({"seed": 0, "events": [{"site": "scheduler.post-checkpoint",
                                              "occurrence": 1, "action": "kill", "args": {}}]}, f)
        state = os.path.join(tmp, "rung2")
        args = ["serve", rfx["config"], "--state-dir", state, "--buckets",
                f"{len(rtrs)}x{rpages}", "--chunk-steps", str(rfx["chunk_steps"]),
                "--attest", "chain"]
        t0 = time.perf_counter()
        proc, sock = spawn_daemon(args + ["--checkpoint-wall", "2", "--idle-exit", "30"],
                                  env={"PRIMETPU_CHAOS_PLAN": plan, "PRIMETPU_CHAOS_MODE": "kill"})
        procs.append(proc)
        # all four at once, so that they are admitted together, before the
        # first periodic checkpoint (2 s after the scheduler was made)
        with ThreadPoolExecutor(len(rfx["jobs"])) as pool:
            ids = [f.result()["job_id"] for f in [pool.submit(
                ServeClient(sock, timeout_s=60.0).submit, synth=j["synth"],
                overrides=j["overrides"], fold=True) for j in rfx["jobs"]]]
        proc.communicate(timeout=600)
        killed_s = time.perf_counter() - t0
        before, _ = fold_records(JobJournal(state).replay()[0])
        ckpts = sorted(os.listdir(os.path.join(state, "jobs")))
        proc2, sock2 = spawn_daemon(args + ["--checkpoint-wall", "3600"])
        procs.append(proc2)
        cli2 = ServeClient(sock2, timeout_s=60.0)
        results = [cli2.wait(i, timeout_s=900.0) for i in ids]
        health = cli2.health()
        cli2.drain()
        out, err = proc2.communicate(timeout=600)
        recover_s = time.perf_counter() - t0 - killed_s
        records, dropped = JobJournal(state).replay()
        after, _ = fold_records(records)
        dstats = health["device"]
        launches = dstats["kernel_launches"]
        same = [r["state"] == "DONE" and served(r["result"]) == j["digest"]
                for r, j in zip(results, rfx["jobs"])]
        chains = [r.get("result", {}).get("attest") == j["attest"]
                  for r, j in zip(results, rfx["jobs"])]
        line = {"phase": "serve_recover", "bucket": f"{len(rtrs)}x{rpages}",
                "chunk_steps": rfx["chunk_steps"], "killed_returncode": proc.returncode,
                "killed_after_s": killed_s,
                "states_at_kill": {i: before[i].state for i in before},
                "element_checkpoints_at_kill": ckpts, "recovered": health["recovered"],
                "recover_wall_s": recover_s, "journal_records": len(records),
                "journal_torn_tail": dropped,
                "job_steps": [r.get("result", {}).get("steps") for r in results],
                "fleet_steps_after_restart": dstats["fleet_steps"], "launches": launches,
                "results_equal_jax": same, "heads_equal_jax": chains,
                "daemon_returncode": proc2.returncode, "gpu": smi_line}
        if proc.returncode != -9:
            problems.append(f"serve_recover: the chaos crashpoint did not kill the daemon "
                            f"(exit {proc.returncode})")
        if sorted(before) != sorted(ids) or all(j.terminal for j in before.values()) \
                or not ckpts:
            problems.append(f"serve_recover: the kill landed with jobs {before} and "
                            f"checkpoints {ckpts}: not mid-service")
        if sorted(after) != sorted(ids) or any(j.state != "DONE" for j in after.values()):
            problems.append(f"serve_recover: the journal lost a job: {after}")
        if not all(same) or not all(chains):
            problems.append(f"serve_recover: results {same}, chain heads {chains} against "
                            "the JAX runs")
        if proc2.returncode != 0:
            problems.append(f"serve_recover: the restarted daemon exited {proc2.returncode}: "
                            f"{err[-500:]}")
        n = dstats["fleet_steps"]
        for k, c in dstats["kernel_launches"].items():
            if c != (n if k in STEP_KERNELS else 0):
                problems.append(f"serve_recover: {k} launched {c} times in {n} fleet steps")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return line, launches, problems


def worker_lines(err: str) -> tuple[dict, dict]:
    """A pool's worker lines on stderr: {worker id: the device line} and
    {worker id: the exit record (units, checkpoint seconds, unit walls,
    kernel launches)}."""
    devices, exits = {}, {}
    for ln in err.splitlines():
        if not ln.startswith("worker "):
            continue
        wid, _, rest = ln[len("worker "):].partition(": ")
        if rest.startswith("device "):
            devices[wid] = rest
        elif rest.startswith("exit "):
            exits[wid] = json.JSONDecoder().raw_decode(rest.partition(", ")[2])[0]
    return devices, exits


def pool_launches(path: str, exits: dict, at_least: int) -> dict:
    """The step kernels' launches summed over a pool's workers (those that
    printed an exit line): each step kernel as often as the others, at
    least `at_least` times, router_cascade never. Returns the sums."""
    total = dict.fromkeys(KERNEL_META, 0)
    for rec in exits.values():
        for k, n in rec["launches"].items():
            total[k] += n
    if total["router_cascade"] or len({total[k] for k in STEP_KERNELS}) != 1 \
            or total["probe_classify"] < at_least:
        fail(f"{path}: the workers launched {total} (at least {at_least} each step kernel)")
    return total


def keep_unit_checkpoints(units_dir: str, kept: str, stop) -> None:
    """Until `stop` is set: copy each unit checkpoint (units/<uid>.npz,
    written by an atomic rename) into `kept` the first time it is seen."""
    os.makedirs(kept, exist_ok=True)
    while True:
        done = stop.is_set()
        for name in os.listdir(units_dir) if os.path.isdir(units_dir) else ():
            if name.endswith(".npz") and not os.path.exists(os.path.join(kept, name)):
                try:
                    shutil.copyfile(os.path.join(units_dir, name), os.path.join(kept, name))
                except FileNotFoundError:  # reaped at its ack meanwhile
                    pass
        if done:
            return
        time.sleep(0.1)


def audit_pool(pool_dir: str, kept: str, resumed: dict, jobs: list, smi_line: str):
    """audit_pool (module docstring), in pool_headline's thread after it:
    the resumed unit's first checkpoint put back into the pool directory,
    `fsck` of the directory clean, then `audit` of it on the card: every
    unit `ok` with its ack confirmed, the checkpoint a prefix of its replay,
    each step kernel launched once per replayed step. Returns (its phase
    line, the audit process's launch counts)."""
    victim = next((u for u, n in sorted(resumed.items()) if n > 0), None)
    if victim is None or not os.path.exists(os.path.join(kept, f"{victim}.npz")):
        fail(f"audit_pool: no kept checkpoint of the resumed unit ({resumed}, "
             f"kept {sorted(os.listdir(kept))})")
    os.makedirs(os.path.join(pool_dir, "units"), exist_ok=True)
    shutil.copyfile(os.path.join(kept, f"{victim}.npz"),
                    os.path.join(pool_dir, "units", f"{victim}.npz"))
    from primesim_tpu_torch.analysis.fsck import render_json, run_fsck

    t0 = time.perf_counter()
    started = round(t0 - T0, 1)
    report = json.loads(render_json(run_fsck(pool_dir)))  # no device: in this process
    fsck_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    au = subprocess.run([sys.executable, "-m", "primesim_tpu_torch", "audit", pool_dir],
                        cwd=ROOT, capture_output=True, text=True, timeout=600)
    audit_s = time.perf_counter() - t1
    if au.returncode != 0:
        fail(f"audit_pool: audit exited {au.returncode}: {au.stdout[-1000:]} {au.stderr[-1000:]}")
    verdicts = [json.loads(ln) for ln in au.stdout.splitlines() if ln.strip()]
    dev_line = [ln for ln in au.stderr.splitlines() if ln.startswith("audit: device ")]
    if len(dev_line) != 1 or not dev_line[0].startswith("audit: device cuda"):
        fail(f"audit_pool: the audit did not run on the card: {au.stderr[-1000:]}")
    extra = json.loads(dev_line[0].partition(", ")[2])
    launches = extra["launches"]
    steps = sum(j["digest"]["steps"] for j in jobs)
    by = {v["unit_id"]: v for v in verdicts}
    line = {"phase": "audit_pool", "units": len(verdicts),
            "statuses": {u: v["status"] for u, v in by.items()},
            "resumed_unit": victim, "checkpoint": by.get(victim, {}).get("detail", {})
            .get("checkpoint"), "fsck_s": fsck_s, "fsck_checked": report["checked"],
            "fsck_summary": report["summary"], "audit_s": audit_s,
            "replay_wall_s": extra["replay_wall_s"], "replayed_steps": steps,
            "launches": launches, "started_t_s": started,
            "ended_t_s": round(time.perf_counter() - T0, 1), "gpu": smi_line}
    if report["summary"]["corrupt"] or report["checked"]["checkpoints"] != 1:
        fail(f"audit_pool: fsck found {report['findings']} over {report['checked']}")
    if len(verdicts) != len(jobs) or any(
            v["status"] != "ok" or v["detail"].get("ack") != "confirmed" for v in verdicts):
        fail(f"audit_pool: verdicts {verdicts}")
    if not str(line["checkpoint"]).startswith("prefix ok at chunk "):
        fail(f"audit_pool: the resumed unit's checkpoint was not held to its replay: "
             f"{by.get(victim)}")
    heads = sorted(v["detail"]["replay"]["head"] for v in verdicts)
    if heads != sorted(j["attest"]["head"] for j in jobs):
        fail(f"audit_pool: replayed heads {heads} are not the JAX runs'")
    if launches["router_cascade"] or len({launches[k] for k in STEP_KERNELS}) != 1 \
            or launches["probe_classify"] < steps:
        fail(f"audit_pool: the replays launched {launches} for {steps} steps")
    return line, launches


def pool_phase(path: str, smi_line: str, headline) -> tuple[list, dict]:
    """A pooled path, pool_headline or dispatch_rung2 (module docstring),
    for a background thread: a process tree of its own that shares the
    card with the main thread's phases 3 and 4. `headline` is the headline
    fixture (record, machine, trace). Returns (its phase line, for the
    main thread to print, and its launch counts, summed over its worker
    processes, each of which counts from 0)."""
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.serve import JobJournal
    from primesim_tpu_torch.serve.client import ServeClient
    from primesim_tpu_torch.serve.protocol import request
    from primesim_tpu_torch.serve.scheduler import PAGE_EVENTS, parse_synth_spec
    from primesim_tpu_torch.pool.units import fold_unit_records
    from primesim_tpu_torch.stats.digest import run_digest

    def served(result):
        d = run_digest(result["steps"], result["core_cycles"],
                       {k: np.asarray(v) for k, v in result["counters"].items()}, [], [])
        return {k: v for k, v in d.items() if k not in ("link_free_sha256", "dram_free_sha256")}

    def on_the_card(path, devices, exits):
        """Every worker that ran a unit (an exit record with units done, or
        a killed one with a device line) names the card; an autoscaled
        worker that idled out before it leased anything has no device."""
        name = smi_line.split(",")[0].strip()
        ran = set(devices) | {w for w, x in exits.items() if x["units_done"]}
        off = [w for w in ran if not devices.get(w, "").startswith("device cuda")
               or name not in devices.get(w, "")]
        if not ran or off:
            fail(f"{path}: workers {off or 'none'} did not name the card ({devices}, "
                 f"exits {exits})")

    launches, lines = {}, []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    procs = []
    try:
        if path == "pool_headline":
            # ---- pool_headline: `sweep --workers 2` on the headline machine,
            # serve_headline's elements 0, 1 and 7 as units, worker w0 killed
            # after its first checkpointed chunk
            hfx, cfg, _ = headline
            sfx = fixture_json("serve_headline")
            jobs = [j for j in sfx["jobs"] if j["element"] in SERVE_ELEMENTS]
            cfg_path = os.path.join(tmp, "headline.json")
            with open(cfg_path, "w") as f:
                f.write(cfg.to_json())
            argv = [sys.executable, "-m", "primesim_tpu_torch", "sweep", cfg_path, "--fold",
                    "--workers", "2", "--attest", "chain", "--chunk-steps", str(sfx["chunk_steps"]),
                    "--lease-ttl", str(POOL_TTL), "--pool-dir", os.path.join(tmp, "pool")]
            for j in jobs:
                ts = j["trace"]
                argv += ["--synth", ts["generator"] + ":" + ",".join(
                    f"{k}={v}" for k, v in ts["args"].items() if k != "n_cores")]
                # element 0 has no overrides: llc_lat=10 is the machine's own
                # LLC latency, so its effective config is the machine's
                argv += ["--vary", ",".join(f"{k}={v}" for k, v in j["overrides"].items())
                         or f"llc_lat={cfg.llc.latency}"]
            t0 = time.perf_counter()
            started = round(t0 - T0, 1)
            # the first unit checkpoint each unit writes, copied aside as it
            # lands (the coordinator reaps them at each ack): audit_pool
            # puts the resumed unit's back and holds it to the replay
            kept, stop = os.path.join(tmp, "kept_units"), threading.Event()
            watcher = threading.Thread(target=keep_unit_checkpoints,
                                       args=(os.path.join(tmp, "pool", "units"), kept, stop))
            watcher.start()
            try:
                sp = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=900,
                                    env={**os.environ, "PRIMETPU_POOL_CRASH": POOL_CRASH})
            finally:
                stop.set()
                watcher.join()
            wall = time.perf_counter() - t0
            if sp.returncode != 0:
                fail(f"pool_headline: sweep exited {sp.returncode}: {sp.stderr[-2000:]}")
            rows = [json.loads(ln) for ln in sp.stdout.splitlines() if ln.strip()]
            elems = [r for r in rows if r["metric"] == "simulated_MIPS"]
            pool = rows[-1]["detail"]["pool"]
            records, _ = JobJournal(os.path.join(tmp, "pool")).replay()
            folded, _ = fold_unit_records(records)
            resumed = {u: f["resumed_steps"] for u, f in sorted(folded.items())}
            devices, exits = worker_lines(sp.stderr)
            same = [len(elems) == len(jobs) and all(
                e["detail"][k] == j["digest"][k] for k in ("instructions", "max_core_cycles"))
                and e["detail"]["attest"] == j["attest"] for e, j in zip(elems, jobs)]
            launches["pool_headline"] = pool_launches(
                "pool_headline", exits,
                sum(j["digest"]["steps"] for j in jobs) - sum(resumed.values()))
            lines.append({"phase": "pool_headline", "workers": 2, "crash": POOL_CRASH,
                  "lease_ttl_s": POOL_TTL, "elements": [j["element"] for j in jobs],
                  "unit_steps": [j["digest"]["steps"] for j in jobs], "wall_s": wall,
                  "pool": pool, "resumed_steps": resumed,
                  "unit_wall_s": [e["detail"]["wall_s"] for e in elems],
                  "worker_unit_walls_s": {w: x["unit_walls_s"] for w, x in exits.items()},
                  "checkpoint_s": {w: x["checkpoint_s"] for w, x in exits.items()},
                  "kernel_load_s": {w: x["kernel_load_s"] for w, x in exits.items()},
                  "workers_exited": sorted(exits), "devices": devices,
                  "results_equal_jax": same, "launches": launches["pool_headline"],
                  "started_t_s": started, "ended_t_s": round(time.perf_counter() - T0, 1),
                  "gpu": smi_line})
            if not all(same):
                fail(f"pool_headline: results or heads differ from the JAX runs: {same}")
            if pool["expired_leases"] < 1 or pool["redispatches"] < 1 or "w0" in exits:
                fail(f"pool_headline: no kill was recovered: {pool}, exits {sorted(exits)}")
            if not any(v > 0 for v in resumed.values()):
                fail(f"pool_headline: no unit resumed from its checkpoint: {resumed}")
            on_the_card("pool_headline", devices, exits)
            line, launches["audit_pool"] = audit_pool(
                os.path.join(tmp, "pool"), kept, resumed, jobs, smi_line)
            lines.append(line)

        if path == "dispatch_rung2":
            # ---- dispatch_rung2: the daemon on rung 2 dispatching serve_rung2's
            # jobs to an autoscaled pool of 2 workers, every unit audited
            rfx = fixture_json("serve_rung2")
            with open(os.path.join(ROOT, rfx["config"])) as f:
                rcfg = MachineConfig.from_json(f.read())
            rtrs = [parse_synth_spec(j["synth"], rcfg.n_cores, True) for j in rfx["jobs"]]
            pages = -(-max(tr.max_len for tr in rtrs) // PAGE_EVENTS)
            pool_dir = os.path.join(tmp, "dispatch_pool")
            t0 = time.perf_counter()
            started = round(t0 - T0, 1)
            proc, sock = spawn_daemon(
                ["serve", rfx["config"], "--state-dir", os.path.join(tmp, "dispatch"),
                 "--pool-dir", pool_dir, "--workers", "2", "--buckets",
                 f"{len(rtrs)}x{pages}", "--chunk-steps", str(rfx["chunk_steps"]),
                 "--attest", "chain", "--audit-rate", "1.0"])
            procs.append(proc)
            with ThreadPoolExecutor(len(rfx["jobs"])) as ex:
                ids = [f.result()["job_id"] for f in [ex.submit(
                    ServeClient(sock, timeout_s=60.0).submit, synth=j["synth"],
                    overrides=j["overrides"], fold=True) for j in rfx["jobs"]]]
            cli = ServeClient(sock, timeout_s=60.0)
            results = [cli.wait(i, timeout_s=600.0) for i in ids]
            jobs_wall = time.perf_counter() - t0
            deadline = time.time() + 300
            while True:
                c = request(os.path.join(pool_dir, "pool.sock"), {"verb": "status"})["counters"]
                if c["audits_ok"] + c["attest_mismatches"] >= len(ids) or time.time() > deadline:
                    break
                time.sleep(0.2)
            audits_wall = time.perf_counter() - t0
            health = cli.health()
            cli.drain()
            _, err = proc.communicate(timeout=300)
            devices, exits = worker_lines(err)
            same = [r["state"] == "DONE" and served(r["result"]) == j["digest"]
                    and r["result"].get("attest") == j["attest"]
                    for r, j in zip(results, rfx["jobs"])]
            steps = sum(j["digest"]["steps"] for j in rfx["jobs"])
            launches["dispatch_rung2"] = pool_launches("dispatch_rung2", exits, 2 * steps)
            lines.append({"phase": "dispatch_rung2", "workers": health["workers"],
                  "bucket": f"{len(rtrs)}x{pages}", "chunk_steps": rfx["chunk_steps"],
                  "job_steps": [r.get("result", {}).get("steps") for r in results],
                  "jobs_wall_s": jobs_wall, "audits_wall_s": audits_wall,
                  "coordinator": {k: c[k] for k in ("leases", "acks", "duplicates", "hedges",
                                                    "audits", "audits_ok", "attest_confirms",
                                                    "attest_mismatches", "expired")},
                  "checkpoint_s": {w: x["checkpoint_s"] for w, x in exits.items()},
                  "units_done": {w: x["units_done"] for w, x in exits.items()},
                  "devices": devices, "results_equal_jax": same,
                  "launches": launches["dispatch_rung2"],
                  "daemon_returncode": proc.returncode, "started_t_s": started,
                  "ended_t_s": round(time.perf_counter() - T0, 1), "gpu": smi_line})
            if not all(same):
                fail(f"dispatch_rung2: results or heads differ from the JAX runs: {same}")
            if (c["audits"], c["audits_ok"]) != (len(ids), len(ids)):
                fail(f"dispatch_rung2: audits {c['audits']}, passed {c['audits_ok']}")
            if proc.returncode != 0:
                fail(f"dispatch_rung2: the daemon exited {proc.returncode}: {err[-1000:]}")
            on_the_card("dispatch_rung2", devices, exits)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return lines, launches


class Child:
    """A `python -m primesim_tpu_torch` child whose stderr lines are
    collected by a thread, each with the script's clock when it arrived."""

    def __init__(self, args: list[str]):
        self.proc = subprocess.Popen([sys.executable, "-m", "primesim_tpu_torch", *args],
                                     cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
        self.lines: list = []  # (time.perf_counter(), line)
        self.out = ""
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()
        self._o = threading.Thread(target=self._read_out, daemon=True)
        self._o.start()

    def _read(self) -> None:
        for ln in self.proc.stderr:
            self.lines.append((time.perf_counter(), ln.rstrip("\n")))

    def _read_out(self) -> None:
        self.out = self.proc.stdout.read()

    def wait_line(self, what: str, timeout: float = 300.0, start: int = 0):
        """(arrival time, line) of the first stderr line from `start` on that
        holds `what`; fails if the child exits first or it never comes."""
        deadline = time.time() + timeout
        while True:
            for t, ln in self.lines[start:]:
                if what in ln:
                    return t, ln
            if self.proc.poll() is not None and not self._t.is_alive():
                fail(f"a child exited {self.proc.returncode} before {what!r}: "
                     f"{[ln for _, ln in self.lines][-20:]}")
            if time.time() > deadline:
                fail(f"no {what!r} line within {timeout} s: {[ln for _, ln in self.lines][-20:]}")
            time.sleep(0.05)

    def finish(self, timeout: float = 600.0) -> int:
        self.proc.wait(timeout=timeout)
        self._t.join(timeout=30)
        self._o.join(timeout=30)
        return self.proc.returncode

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def fixture_json(name: str) -> dict:
    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", f"{name}.json")) as f:
        return json.load(f)


def run_child(args: list[str], timeout: float = 900.0,
              env: dict | None = None) -> tuple[int, str, str, float]:
    """`python <args>` from the checkout's root, with `env` added to this
    process's environment: (returncode, stdout, stderr, wall s)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout, env={**os.environ, **(env or {})})
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0


def port_line(err: str, verb: str) -> dict:
    """The record of the port's `<verb>: device D, {...}` stderr line,
    which must name the card."""
    for ln in err.splitlines():
        if ln.startswith(f"{verb}: device "):
            dev, _, rec = ln[len(f"{verb}: device "):].partition(", ")
            if not dev.startswith("cuda"):
                fail(f"{verb}: ran on {dev}, not the card")
            return json.loads(rec)
    fail(f"{verb}: no device line on stderr: {err[-2000:]}")


def step_launches(path: str, launches: dict, per: int | None) -> dict:
    """Each step kernel launched `per` times (as often as the others and
    at least once when `per` is None), router_cascade never."""
    n = {launches[k] for k in STEP_KERNELS}
    if launches["router_cascade"] or len(n) != 1 or (per is None and not min(n)) \
            or (per is not None and n != {per}):
        fail(f"{path}: launches {launches}, want {per if per is not None else 'n > 0'} "
             "of each step kernel and no router_cascade")
    return dict(launches)


def calibrate_phase(path: str, smi_line: str) -> tuple[dict, dict]:
    """calibrate_rung1 / calibrate_zoo_selftest (module docstring): the
    `calibrate` verb in a child process, its lines and report held to the
    JAX fit's (fixtures/calib_rung1.json, calib_zoo_selftest.json).
    Returns (its phase line, {path: launches})."""
    fx = fixture_json(path.replace("calibrate_", "calib_"))
    want = fx["report"]
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{path}_") as tmp:
        out_file = os.path.join(tmp, "fit.json")
        args = ["-m", "primesim_tpu_torch", "calibrate", fx["config"], "--table", fx["table"],
                "--rounds", str(fx["rounds"]), "--chunk-steps", str(fx["chunk_steps"]),
                "--out", out_file]
        if fx["fit"]:
            args += ["--fit", ",".join(fx["fit"])]
        if fx["truth"]:
            args += ["--selftest", "--truth", ",".join(f"{k}={v}" for k, v in fx["truth"].items())]
        rc, out, err, wall = run_child(args)
        if rc != 0:
            fail(f"{path}: calibrate exited {rc}: {err[-2000:]}")
        with open(out_file) as f:
            report = json.load(f)
    rows = [json.loads(ln) for ln in out.splitlines()]
    residuals = [{"metric": "calibrate_residual", "value": round(r["residual"], 6),
                  "unit": "relative",
                  "detail": {"entry": r["entry"], "simulated": round(r["simulated"], 4),
                             "observed": round(r["observed"], 4), "table": fx["table_name"]}}
                 for r in want["residuals"]]
    if rows[:-1] != residuals:
        fail(f"{path}: residual lines {rows[:-1]} != the JAX fit's {residuals}")
    fit_line = rows[-1]
    got = {k: fit_line["detail"][k] for k in ("knobs", "start", "rounds", "fleet_runs", "batch")}
    if fit_line["value"] != round(want["cost"], 8) or got != {k: want[k] for k in got}:
        fail(f"{path}: calibrate_fit {fit_line} != the JAX fit's {want}")
    if fx["truth"] and not (fit_line["detail"]["recovered"] and fit_line["detail"]["selftest_ok"]):
        fail(f"{path}: the self-test did not recover {fx['truth']}: {fit_line}")
    if {k: report[k] for k in want} != want:
        fail(f"{path}: the --out report differs from the JAX fit's")
    stats = port_line(err, "calibrate")
    launches = step_launches(path, stats["launches"], stats["fleet_steps"])
    if stats["fleet_runs"] != want["fleet_runs"]:
        fail(f"{path}: {stats['fleet_runs']} dispatches, the report says {want['fleet_runs']}")
    line = {"phase": path, "config": fx["config"], "fit_keys": fit_line["detail"]["fit_keys"],
            "knobs": got["knobs"], "cost": want["cost"], "rounds": got["rounds"],
            "fleet_runs": stats["fleet_runs"], "batch": got["batch"],
            "fleet_steps": stats["fleet_steps"], "instructions": stats["instructions"],
            "fit_wall_s": stats["wall_s"],
            "MIPS": stats["instructions"] / stats["wall_s"] / 1e6,
            "ms_per_dispatch": 1e3 * stats["wall_s"] / stats["fleet_runs"],
            "process_wall_s": wall, "launches": launches, "equal_to_jax": True,
            "gpu": smi_line}
    return line, {path: launches}


def chaos_rung2_phase(smi_line: str) -> tuple[dict, dict]:
    """chaos_rung2 (module docstring): the `chaos` verb in a child
    process on the shipped rung-2 machine, its report and per-trial lines
    held to the JAX campaign's."""
    fx = fixture_json("chaos_rung2")
    rc, out, err, wall = run_child(
        ["-m", "primesim_tpu_torch", "chaos", "--config", fx["config"], "--trials",
         str(fx["trials"]), "--seed", str(fx["seed0"]), "--classes", ",".join(fx["classes"]),
         "--verbose"])
    if rc != 0:
        fail(f"chaos_rung2: chaos exited {rc}: {out[-1000:]} {err[-2000:]}")
    report = json.loads(out)
    if report != fx["report"]:
        fail(f"chaos_rung2: report {report} != the JAX campaign's {fx['report']}")
    trials = [ln for ln in err.splitlines() if ln.startswith("trial ")]
    want = [f"trial seed={t['seed']} {'ok' if t['ok'] else 'VIOLATION'} "
            f"fired={len(t['injected'])} restarts={t['restarts']}" for t in fx["trial_results"]]
    if trials != want:
        fail(f"chaos_rung2: trial lines {trials} != the JAX campaign's {want}")
    stats = port_line(err, "chaos")
    launches = step_launches("chaos_rung2", stats["launches"], None)
    return {"phase": "chaos_rung2", "config": fx["config"], "trials": report["trials"],
            "fired_events": report["fired_events"], "ok": report["ok"],
            "restarts": [t["restarts"] for t in fx["trial_results"]],
            "campaign_wall_s": stats["wall_s"], "process_wall_s": wall,
            "launches": launches, "equal_to_jax": True, "gpu": smi_line}, \
        {"chaos_rung2": launches}


def child_phase(path: str, smi_line: str) -> tuple[dict, dict]:
    """calib_ipu_matrix / chaos_classes: this script's `--child PATH` mode
    in a process of its own (its launches are its own). Returns (its
    phase line, {path: launches})."""
    rc, out, err, wall = run_child([os.path.join(ROOT, "chip_smoke.py"), "--child", path])
    if rc != 0:
        fail(f"{path}: the child exited {rc}: {err[-3000:]}")
    line = json.loads(out.strip().splitlines()[-1])
    return {**line, "process_wall_s": wall, "gpu": smi_line}, {path: line["launches"]}


def calib_chaos_phases(smi_line: str) -> tuple[list, dict]:
    """The calibrate and chaos paths after calibrate_rung1 (module
    docstring), one after another in one background thread."""
    lines, launches = [], {}
    for fn, args in ((calibrate_phase, ("calibrate_zoo_selftest", smi_line)),
                     (child_phase, ("calib_ipu_matrix", smi_line)),
                     (chaos_rung2_phase, (smi_line,)),
                     (child_phase, ("chaos_classes", smi_line))):
        line, of = fn(*args)
        lines.append(line)
        launches.update(of)
    return lines, launches


def cache_overlap_phases(smi_line: str) -> tuple[list, dict]:
    """Phase 15 (module docstring): cache_cold, cache_warm and
    overlap_fleet as `python -m primesim_tpu_torch` children on one fresh
    cache directory, then overlap_supervised in a child of its own.
    Returns (their phase lines, {path: launches})."""
    fx = fixture_json("serve_rung2")
    job, chunk = fx["jobs"][CACHE_JOB], fx["chunk_steps"]
    with open(os.path.join(ROOT, fx["config"])) as f:
        llc_lat = json.load(f)["llc"]["latency"]
    cdir = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    env = {"PRIMETPU_CACHE_DIR": os.path.join(cdir, "cache")}
    lines, launches = [], {}

    def metric_lines(out):
        return {ln["metric"]: ln for ln in map(json.loads, out.splitlines())}

    def cache_stats(path, got, want):
        ec = got["exec_cache"]["detail"]
        if (ec["hits"], ec["misses"], ec["errors"]) != want or ec.get("warnings"):
            fail(f"{path}: exec_cache {ec}, want hits, misses, errors {want}")
        if not ec["misses"] and ec["compile_wall_s"] != 0.0:
            fail(f"{path}: a warm process ran nvcc for {ec['compile_wall_s']} s")
        return ec

    try:
        run = ["-m", "primesim_tpu_torch", "run", fx["config"], "--synth", job["synth"],
               "--fold", "--chunk-steps", str(chunk), "--attest", "chain",
               "--exec-cache", "on"]
        want_sum = {"instructions": job["digest"]["instructions"],
                    "max_core_cycles": job["digest"]["max_core_cycles"],
                    "noc_msgs": job["digest"]["counter_sums"]["noc_msgs"],
                    "steps": job["digest"]["steps"], "attest": job["attest"]}
        for path, want in (("cache_cold", (0, 4, 0)), ("cache_warm", (4, 0, 0))):
            rc, out, err, wall = run_child(run, env=env)
            if rc != 0:
                fail(f"{path}: run exited {rc}: {err[-2000:]}")
            got = metric_lines(out)
            ec = cache_stats(path, got, want)
            summ = got["simulated_MIPS"]["detail"]
            if {k: summ[k] for k in want_sum} != want_sum:
                fail(f"{path}: summary {summ} != the JAX job's {want_sum}")
            stats = port_line(err, "exec_cache")
            launches[path] = step_launches(path, stats["launches"], summ["steps"])
            lines.append({"phase": path, "config": fx["config"], "synth": job["synth"],
                          "time_to_first_step": got["time_to_first_step"],
                          "exec_cache": got["exec_cache"], "entries": stats["keys"],
                          "run_wall_s": summ["wall_s"], "steps": summ["steps"],
                          "process_wall_s": wall, "equal_to_jax": True,
                          "launches": launches[path], "gpu": smi_line})

        # overlap_fleet: the four jobs as one B = 4 sweep, one final snapshot
        ck = os.path.join(cdir, "ck")
        varies = [",".join(f"{k}={v}" for k, v in j["overrides"].items())
                  or f"llc_lat={llc_lat}" for j in fx["jobs"]]
        sweep = ["-m", "primesim_tpu_torch", "sweep", fx["config"],
                 *[a for j in fx["jobs"] for a in ("--synth", j["synth"])], "--fold",
                 *[a for v in varies for a in ("--vary", v)], "--chunk-steps", str(chunk),
                 "--overlap", "on", "--exec-cache", "on", "--checkpoint-dir", ck,
                 "--checkpoint-every", "1000"]
        rc, out, err, wall = run_child(sweep, env=env)
        if rc != 0:
            fail(f"overlap_fleet: sweep exited {rc}: {err[-2000:]}")
        got = [json.loads(ln) for ln in out.splitlines()]
        ec = cache_stats("overlap_fleet", {ln["metric"]: ln for ln in got}, (4, 0, 0))
        from primesim_tpu_torch.sim.checkpoint import load_verified_npz
        from primesim_tpu_torch.stats.counters import COUNTER_NAMES
        from primesim_tpu_torch.stats.digest import run_digest

        z = load_verified_npz(os.path.join(ck, sorted(os.listdir(ck))[-1]))
        digests = []
        for i, j in enumerate(fx["jobs"]):
            d = run_digest(z["steps_run"][i], z["state_cycles"][i].astype(np.int64)
                           + z["cycle_base"][i],
                           {k: z["host_counters"][n, i] for n, k in enumerate(COUNTER_NAMES)},
                           [], [])
            d = {k: v for k, v in d.items() if k in j["digest"]}
            if d != j["digest"]:
                fail(f"overlap_fleet: element {i} {d} != the JAX job's {j['digest']}")
            digests.append(d["cycles_sha256"][:16])
        stats = port_line(err, "exec_cache")
        fleet_steps = int(z["steps_run"].max())
        launches["overlap_fleet"] = step_launches("overlap_fleet", stats["launches"],
                                                  fleet_steps)
        agg = [ln for ln in got if ln["metric"] == "fleet_aggregate_MIPS"][0]
        lines.append({"phase": "overlap_fleet", "B": len(fx["jobs"]), "varies": varies,
                      "fleet_steps": fleet_steps, "steps": z["steps_run"].tolist(),
                      "exec_cache": ec, "aggregate_MIPS": agg["value"],
                      "fleet_wall_s": agg["detail"]["wall_s"], "process_wall_s": wall,
                      "digests_equal_to_jax": True, "cycles_sha256": digests,
                      "launches": launches["overlap_fleet"], "gpu": smi_line})
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    line, of = child_phase("overlap_supervised", smi_line)
    lines.append(line)
    launches.update(of)
    return lines, launches


def overlap_supervised_child(dev) -> dict:
    """`--child overlap_supervised` (module docstring): the supervised
    job without and with overlap in this process; its phase line."""
    import torch

    from primesim_tpu_torch.attest import SoloAttest
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.kernels import build
    from primesim_tpu_torch.serve.scheduler import parse_synth_spec
    from primesim_tpu_torch.sim.checkpoint import load_verified_npz
    from primesim_tpu_torch.sim.engine import Engine
    from primesim_tpu_torch.sim.supervisor import RunSupervisor
    from primesim_tpu_torch.stats.digest import run_digest

    fx = fixture_json("serve_rung2")
    job, chunk = fx["jobs"][CACHE_JOB], fx["chunk_steps"]
    with open(os.path.join(ROOT, fx["config"])) as f:
        cfg = MachineConfig.from_json(f.read())
    trace = parse_synth_spec(job["synth"], cfg.n_cores, True)
    runs = {}
    for overlap in (False, True):
        snap_dir = tempfile.mkdtemp(prefix="chip_smoke_ovsup_")
        eng = Engine(cfg, trace, chunk_steps=chunk, device=dev)
        eng.overlap = overlap
        eng.attest = SoloAttest(chunk)
        enq, heads, saves, probes = [0], [], [], []
        real_enq, real_save, real_steps = eng._enqueue_chunk, eng.save_checkpoint, eng.run_steps

        def counted(*a, _real=real_enq, _n=enq, **k):
            _n[0] += 1
            return _real(*a, **k)

        def probed_save(path, _eng=eng, _real=real_save, _saves=saves, _probes=probes):
            # was the speculated chunk still running when the snapshot
            # began, and after the snapshot's first read of the state?
            pend = _eng._pending
            done = pend.done if pend is not None else None
            before = done is not None and not done.query()
            t0 = time.perf_counter()
            _eng.state.cycles.cpu()
            t1 = time.perf_counter()
            after = done is not None and not done.query()
            _real(path)
            _saves.append(time.perf_counter() - t0)
            if done is not None:
                _probes.append({"running_at_start": before, "running_after_first_read": after,
                                "first_read_ms": 1e3 * (t1 - t0)})

        calls = [0]

        def fails_once(n, _real=real_steps, _calls=calls):
            _calls[0] += 1
            done = _real(n)
            if _calls[0] == OVERLAP_FAIL_CALL:
                torch.cuda.synchronize()
                raise RuntimeError("UNAVAILABLE: injected after a real chunk on the card")
            return done

        eng._enqueue_chunk, eng.save_checkpoint, eng.run_steps = counted, probed_save, fails_once
        sup = RunSupervisor(eng, snapshot_dir=snap_dir, checkpoint_every_chunks=1,
                            keep_snapshots=1000, guard="off", backoff_s=0.01,
                            on_chunk=lambda s, _e=eng, _h=heads: _h.append(
                                _e.attest.payload()["head"]))
        build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        names = sorted(os.listdir(snap_dir))
        snaps = [load_verified_npz(os.path.join(snap_dir, n)) for n in names]
        shutil.rmtree(snap_dir, ignore_errors=True)
        d = run_digest(eng.steps_run, eng.cycles, eng.counters, [], [])
        runs[overlap] = {"wall_s": wall, "heads": heads, "snaps": snaps, "names": names,
                         "saves": saves, "probes": probes, "enqueued": enq[0],
                         "retries": sup.retries, "launches": dict(build.LAUNCHES),
                         "attest": eng.attest.payload(),
                         "digest": {k: v for k, v in d.items() if k in job["digest"]}}
        del eng, sup
    # a speculation held on the card by a device sleep at its end (on its
    # stream): does a read of the committed state wait for it? Then the
    # same sleep on the current stream, which the read must wait for
    eng = Engine(cfg, trace, chunk_steps=chunk, device=dev)
    eng.overlap = True
    main, real_enq = torch.cuda.current_stream(dev), eng._enqueue_chunk

    def held(*a, _real=real_enq, **k):
        out = _real(*a, **k)
        if torch.cuda.current_stream(dev) != main:
            torch.cuda._sleep(HELD_SLEEP_CYCLES)
        return out

    eng._enqueue_chunk, held_probes = held, []
    for _ in range(3):
        eng.run_steps(chunk)
        main.synchronize()
        pend = eng._pending
        before = not pend.done.query()
        t0 = time.perf_counter()
        eng.state.cycles.cpu()
        t1 = time.perf_counter()
        after = not pend.done.query()
        torch.cuda._sleep(HELD_SLEEP_CYCLES)
        t2 = time.perf_counter()
        eng.state.cycles.cpu()
        held_probes.append({"running_at_start": before, "running_after_first_read": after,
                            "first_read_ms": 1e3 * (t1 - t0),
                            "same_stream_read_ms": 1e3 * (time.perf_counter() - t2)})
    del eng
    off, on = runs[False], runs[True]
    for r in (off, on):
        if r["retries"] != 1 or r["attest"] != job["attest"] or r["digest"] != job["digest"]:
            fail(f"overlap_supervised: retries {r['retries']}, chain {r['attest']}, digest "
                 f"{r['digest']} (the JAX job's: {job['attest']}, {job['digest']})")
        step_launches("overlap_supervised", r["launches"], r["enqueued"] * chunk)
    if on["heads"] != off["heads"] or on["names"] != off["names"]:
        fail(f"overlap_supervised: heads or snapshots differ: {on['heads']} {off['heads']}")
    for name, a, b in zip(on["names"], on["snaps"], off["snaps"]):
        for k in b:
            if k not in a or not np.array_equal(a[k], b[k]) or a[k].dtype != b[k].dtype:
                fail(f"overlap_supervised: snapshot {name} member {k} differs under overlap")
    return {"phase": "overlap_supervised", "config": fx["config"], "synth": job["synth"],
            "chunk_steps": chunk, "steps": job["digest"]["steps"],
            "snapshots": len(on["names"]), "snapshots_equal_to_overlap_off": True,
            "heads_equal": True, "attest_equals_jax": True, "digest_equals_jax": True,
            "retries": on["retries"], "wall_s": {"off": off["wall_s"], "on": on["wall_s"]},
            "save_s": {"off": off["saves"], "on": on["saves"]},
            "enqueued_chunks": {"off": off["enqueued"], "on": on["enqueued"]},
            "snapshot_probes": on["probes"], "held_speculation_probes": held_probes,
            "launches": step_launches("overlap_supervised", on["launches"],
                                      on["enqueued"] * chunk)}


def child_main(path: str) -> int:
    """`chip_smoke.py --child PATH`: one phase in this process, its line
    last on stdout (calib_ipu_matrix, chaos_classes: module docstring)."""
    import torch

    sys.path.insert(0, ROOT)
    from primesim_tpu_torch.kernels import build

    dev = torch.device("cuda")
    for k in build.KERNELS:
        build.library(k)
    build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))
    if path == "overlap_supervised":
        print(json.dumps(overlap_supervised_child(dev)), flush=True)
        return 0
    fx = fixture_json(path)
    t0 = time.perf_counter()
    if path == "calib_ipu_matrix":
        import importlib

        from primesim_tpu_torch.calib.table import load_table
        from primesim_tpu_torch.config.machine import MachineConfig

        F = importlib.import_module("primesim_tpu_torch.calib.fit")
        with open(os.path.join(ROOT, fx["config"])) as f:
            mcfg = MachineConfig.from_json(f.read())
        table = load_table(os.path.join(ROOT, fx["table"]))
        ev = F._FleetEvaluator(mcfg, table, F.build_traces(mcfg, table), fx["chunk_steps"], dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        values = ev(fx["knob_sets"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if values != fx["values"]:
            fail(f"calib_ipu_matrix: {values} != the JAX matrix {fx['values']}")
        line = {"phase": path, "config": fx["config"], "cores": mcfg.n_cores,
                "topology": mcfg.noc.topology, "B": len(fx["knob_sets"]) * len(table.entries),
                "values": values, "fleet_steps": ev.steps, "instructions": ev.instructions,
                "wall_s": wall, "MIPS": ev.instructions / wall / 1e6,
                "peak_device_bytes": torch.cuda.max_memory_allocated() - base,
                "launches": step_launches(path, build.LAUNCHES, ev.steps),
                "equal_to_jax": True}
    else:
        from primesim_tpu_torch.chaos import campaign as C
        from primesim_tpu_torch.chaos import plan as P

        golden = C.golden_run(device=dev)
        if [C._canon(golden[i]) for i in sorted(golden)] != fx["golden"]:
            fail("chaos_classes: the card's golden results differ from JAX's golden_run")
        trials = {}
        for cls, want in fx["trials"].items():
            plan = P.generate(want["seed"], classes=C._gen_classes((cls,)),
                              sites=C._trial_sites((cls,))[0])
            if plan.as_dict() != want["plan"]:
                fail(f"chaos_classes: {cls} seed {want['seed']} expands to {plan.as_dict()}, "
                     f"JAX's to {want['plan']}")
            t1 = time.perf_counter()
            res = C.run_trial(plan, golden=golden, device=dev)
            if not res.ok or not res.injected:
                fail(f"chaos_classes: {cls} trial ok={res.ok} fired={res.injected}: "
                     f"{res.violations}")
            if cls == "capacity_loss" and res.injected != want["injected"]:
                fail(f"chaos_classes: the capacity trial fired {res.injected}, "
                     f"JAX's {want['injected']}")
            trials[cls] = {"seed": want["seed"], "ok": res.ok, "injected": res.injected,
                           "restarts": res.restarts, "wall_s": time.perf_counter() - t1}
        line = {"phase": path, "golden_equal_to_jax": True, "trials": trials,
                "wall_s": time.perf_counter() - t0,
                "launches": step_launches(path, build.LAUNCHES, None)}
    print(json.dumps(line), flush=True)
    return 0


def replicated_phase(smi_line: str, headline) -> tuple[list, dict]:
    """replicated_headline (module docstring), for a background thread
    beside phases 3 and 4: two `replica` daemons, a primary `serve
    --replicas` on the headline machine and a standby `--standby-of` it,
    the primary killed (SIGKILL) and its state directory deleted once the
    replicas hold the jobs' accepts and it has committed a chunk. Returns
    (its phase line, for the main thread to print, and the promoted
    daemon's launch counts)."""
    from primesim_tpu_torch.analysis.fsck import _check_journal_dir, run_compare, run_fsck
    from primesim_tpu_torch.serve.client import ServeClient
    from primesim_tpu_torch.serve.scheduler import PAGE_EVENTS, parse_synth_spec
    from primesim_tpu_torch.stats.digest import run_digest

    def served(result):
        d = run_digest(result["steps"], result["core_cycles"],
                       {k: np.asarray(v) for k, v in result["counters"].items()}, [], [])
        return {k: v for k, v in d.items() if k not in ("link_free_sha256", "dram_free_sha256")}

    def target(line):
        return line.split("listening on ", 1)[1].split(" ", 1)[0]

    hfx, cfg, _ = headline
    with open(os.path.join(ROOT, "primesim_tpu_torch", "fixtures", "serve_headline.json")) as f:
        sfx = json.load(f)
    jobs = [e for e in sfx["jobs"] if e["element"] in SERVE_ELEMENTS]
    specs = [e["trace"]["generator"] + ":" + ",".join(
        f"{k}={v}" for k, v in e["trace"]["args"].items() if k != "n_cores") for e in jobs]
    pages = -(-max(parse_synth_spec(sp, cfg.n_cores, True).max_len for sp in specs)
              // PAGE_EVENTS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_repl_")
    children = []
    try:
        t0 = time.perf_counter()
        started = round(t0 - T0, 1)
        cfg_path = os.path.join(tmp, "headline.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        r_dirs = [os.path.join(tmp, f"replica{i}") for i in range(2)]
        reps = [Child(["replica", "--dir", d, "--tcp", "127.0.0.1:0"]) for d in r_dirs]
        children += reps
        replicas = ",".join(target(r.wait_line("replica: listening on")[1]) for r in reps)
        serve = [cfg_path, "--tcp", "127.0.0.1:0", "--replicas", replicas, "--buckets",
                 f"{len(specs)}x{pages}", "--chunk-steps", str(sfx["chunk_steps"]),
                 "--attest", "chain", "--checkpoint-wall", "3600"]
        a_dir, b_dir = os.path.join(tmp, "primary"), os.path.join(tmp, "standby")
        prim = Child(["serve", "--state-dir", a_dir, *serve])
        children.append(prim)
        _, a_line = prim.wait_line("serve: listening on")
        if "replicated x2 quorum=2 epoch=1" not in a_line:
            fail(f"replicated_headline: the primary's readiness line: {a_line}")
        stby = Child(["serve", "--state-dir", b_dir, *serve, "--standby-of", target(a_line),
                      "--takeover-grace", "1.0"])
        children.append(stby)
        stby.wait_line("serve: standby of")
        cli = ServeClient(target(a_line), timeout_s=60.0)
        t_sub = time.perf_counter()
        # all three at once, so that they are admitted together (one at a
        # time, each would wait out a chunk of the jobs before it)
        with ThreadPoolExecutor(len(specs)) as ex:
            ids = [f.result()["job_id"] for f in [ex.submit(
                ServeClient(target(a_line), timeout_s=60.0).submit, synth=sp,
                overrides=e["overrides"], fold=True) for sp, e in zip(specs, jobs)]]
        # kill once both replicas hold every accept and a chunk is committed
        deadline = time.time() + 600
        while True:
            accepts = [sum(r.get("t") == "accept" for r in _check_journal_dir(d, d)[0])
                       for d in r_dirs]
            health = cli.health()
            if min(accepts) == len(ids) and health["device"]["fleet_steps"] >= sfx["chunk_steps"]:
                break
            if time.time() > deadline:
                fail(f"replicated_headline: accepts {accepts}, health {health}")
            time.sleep(0.1)
        a_repl, a_dev, a_journal = health["replication"], health["device"], health["journal"]
        a_jobs = {k: v for k, v in health["jobs"].items() if v}
        t_kill = time.perf_counter()
        prim.proc.send_signal(signal.SIGKILL)
        prim.finish(timeout=60)
        shutil.rmtree(a_dir)
        t_promote, _ = stby.wait_line("serve: PROMOTING", timeout=120)
        t_ready, b_line = stby.wait_line("serve: listening on", timeout=300)
        cli2 = ServeClient(target(b_line), timeout_s=60.0)
        results = [cli2.wait(i, timeout_s=900.0) for i in ids]
        t_done = time.perf_counter()
        health = cli2.health()
        cli2.drain()
        rc = stby.finish()
        compares = [run_compare(b_dir, d) for d in r_dirs]  # no device: in this process
        fk = run_fsck(b_dir)
        for r in reps:
            r.proc.send_signal(signal.SIGTERM)
        rep_rcs = [r.finish(timeout=60) for r in reps]
    finally:
        for c in children:
            c.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    dstats, repl = health["device"], health["replication"]
    launches = dstats["kernel_launches"]
    same = [r["state"] == "DONE" and served(r["result"]) == e["digest"]
            for r, e in zip(results, jobs)]
    chains = [r.get("result", {}).get("attest") == e["attest"] for r, e in zip(results, jobs)]
    epoch = int(b_line.split("epoch=", 1)[1].split(",")[0].split(" ")[0].rstrip(")"))
    cmp = [c.checked for c in compares]
    line = {"phase": "replicated_headline", "replicas": 2, "quorum": repl["quorum"],
            "bucket": f"{len(specs)}x{pages}", "chunk_steps": sfx["chunk_steps"],
            "elements": [e["element"] for e in jobs],
            "primary_at_kill": {"fleet_steps": a_dev["fleet_steps"], "jobs": a_jobs,
                                "journal_appends": a_journal["appends"],
                                "acks": [x["acks"] for x in a_repl["replicas"]],
                                "epoch": a_repl["epoch"]},
            "takeover_wall_s": t_promote - t_kill, "kill_to_ready_s": t_ready - t_kill,
            "epoch": epoch, "jobs_wall_s": t_done - t_ready,
            "submit_to_done_s": t_done - t_sub,
            "job_steps": [r.get("result", {}).get("steps") for r in results],
            "frames_shipped": health["journal"]["appends"],
            "frames_acked": [x["acks"] for x in repl["replicas"]], "resyncs": repl["resyncs"],
            "quorum_losses": repl["quorum_losses"], "fleet_steps": dstats["fleet_steps"],
            "launches": launches, "fsck_compare": cmp, "fsck_checked": fk.checked,
            "results_equal_jax": same, "heads_equal_jax": chains, "daemon_returncode": rc,
            "replica_returncodes": rep_rcs, "started_t_s": started,
            "ended_t_s": round(time.perf_counter() - T0, 1), "gpu": smi_line}
    if not all(same) or not all(chains):
        fail(f"replicated_headline: results {same}, chain heads {chains} against the JAX runs")
    if epoch <= a_repl["epoch"] or "replicated x2 quorum=2" not in b_line:
        fail(f"replicated_headline: the standby's readiness line: {b_line}")
    if rc != 0 or any(rep_rcs):
        fail(f"replicated_headline: the promoted daemon exited {rc}, the replicas {rep_rcs}: "
             f"{[ln for _, ln in stby.lines][-10:]}")
    if not all(c.clean for c in compares) or not fk.clean:
        fail(f"replicated_headline: fsck --compare {[c.findings for c in compares]}, "
             f"fsck {fk.findings}")
    n = dstats["fleet_steps"]
    if n < max(r["result"]["steps"] for r in results) or any(
            c != (n if k in STEP_KERNELS else 0) for k, c in launches.items()):
        fail(f"replicated_headline: {launches} launches in {n} fleet steps")
    return [line], {"replicated_headline": launches}


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
    from primesim_tpu_torch import cli as tcli
    from primesim_tpu_torch import convert
    from primesim_tpu_torch.config.machine import MachineConfig
    from primesim_tpu_torch.faults import inject
    from primesim_tpu_torch.kernels import build, reductions, router_kernels, step_kernels
    from primesim_tpu_torch.sim.engine import Engine, group_tables, run_chunk
    from primesim_tpu_torch.sim.fleet import FleetEngine
    from primesim_tpu_torch.trace.format import EV_BARRIER, EV_END
    from primesim_tpu_torch.sim.state import dirm_width, llc_meta_width
    from primesim_tpu_torch.stats.digest import run_digest
    from primesim_tpu_torch.trace import synth
    from primesim_tpu_torch.obs import Recorder
    from primesim_tpu_torch.trace.format import fold_ins, multiplex
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    mods = {"probe_classify": step_kernels, "commit_step": step_kernels,
            "sharer_reductions": reductions, "router_cascade": router_kernels}
    wrappers = {k: getattr(m, k) for k, m in mods.items()}
    plains = {k: getattr(m, f"{k}_plain") for k, m in mods.items()}
    # the launch modes of a core shard (phase 16) that have wrappers of
    # their own
    shard_fns = {m: (getattr(step_kernels, m), getattr(step_kernels, f"{m}_plain"))
                 for m in ("probe_classify_staged", "commit_step_rows")}

    def wrapper_of(name):
        return shard_fns[name][0] if name in shard_fns else wrappers[name]

    def plain_of(name):
        return shard_fns[name][1] if name in shard_fns else plains[name]

    fixture = load_fixture

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

    # ---- 14. the calibrate and chaos paths: child processes sharing the
    # card, in two background threads from here on (their checks time
    # nothing); their lines are printed before phase 5
    def calibrate_rung1():
        line, launches_of = calibrate_phase("calibrate_rung1", smi_line)
        return [line], launches_of

    calib_ex = ThreadPoolExecutor(3)
    calib_fs = [calib_ex.submit(calibrate_rung1), calib_ex.submit(calib_chaos_phases, smi_line),
                # ---- 15. the kernel build cache and overlapped dispatch:
                # child processes in a third thread
                calib_ex.submit(cache_overlap_phases, smi_line)]

    t0 = time.perf_counter()
    hfx, cfg, trace = fixture("headline")
    # ---- 13. the pooled paths: worker processes sharing the card, in two
    # background threads beside phases 3 and 4 (their checks time nothing),
    # cli_supervised (child processes too) after dispatch_rung2; their lines
    # are printed before phase 5
    def dispatch_then_cli():
        lines, launches_of = pool_phase("dispatch_rung2", smi_line, (hfx, cfg, trace))
        return lines + cli_supervised_phase(), launches_of

    pool_ex = ThreadPoolExecutor(3)
    pool_fs = [pool_ex.submit(pool_phase, "pool_headline", smi_line, (hfx, cfg, trace)),
               pool_ex.submit(dispatch_then_cli),
               pool_ex.submit(replicated_phase, smi_line, (hfx, cfg, trace))]
    r3fx, cfg3, trace3 = fixture("rung3_headline")
    if trace3.events.tobytes() != trace.events.tobytes():
        fail("rung 3's fixture names another trace than the headline's")
    large = {path: fixture(name) for path, name in LARGE}
    cfg4, cfg5 = large["rung4"][1], large["rung5"][1]
    zoo = {path: fixture(name) for path, name in ZOO}
    cfg_ipu, cfg_hm = zoo["ipu"][1], zoo["headline_moesi"][1]
    hffx, cfg_hf, trace_hf = fixture("headline_faults")
    if trace_hf.events.tobytes() != trace.events.tobytes():
        fail("headline_faults' fixture names another trace than the headline's")
    mpfx, cfg_mp, trace_mp = fixture("multiprog_rung3")
    r2fx, cfg2, trace2 = fixture("rung2_full")
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
        if name in STEP_KERNELS or name in shard_fns:
            return fn(mcfg or cfg, *args, **(kw or {}))
        return fn(*args, **(kw or {}))

    def card_cut(eng):
        """What same_run compares of an engine, copied to the host now (the
        card run goes on; the CPU stops here)."""
        return SimpleNamespace(state_np=convert.state_to_numpy(eng.state),
                               steps_run=eng.steps_run, cycles=eng.cycles,
                               counters={k: v.copy() for k, v in eng.counters.items()})

    def cpu_repeat(mcfg, rtr, chunk, depth=None):
        """The port's CPU run of a machine, to `depth` steps or to the end:
        (the engine, its seconds)."""
        t0 = time.perf_counter()
        cpu = Engine(mcfg, rtr, chunk_steps=chunk, device="cpu")
        cpu.run_steps(depth) if depth else cpu.run()
        return cpu, time.perf_counter() - t0

    def same_run(phase, gpu, cpu):
        """Fail unless two engines (or a card_cut and an engine) agree in
        steps, per-core cycles, every counter and every state field;
        returns the card's state as numpy."""
        gs = gpu.state_np if hasattr(gpu, "state_np") else convert.state_to_numpy(gpu.state)
        cs = convert.state_to_numpy(cpu.state)
        for f in gs:
            same = (all(np.array_equal(gs[f][k], cs[f][k]) for k in gs[f])
                    if f in ("knobs", "faults") else np.array_equal(gs[f], cs[f]))
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

    def solo_args(name, args):
        """A wrapper's arguments from a solo engine's batch-first step (a
        batch of one) in the solo shapes, as views: the leading element
        axis dropped from all but the shared core ids. The wrappers take
        both shapes; the staging, timing and bounds below read solo ones."""
        return [x[0] if torch.is_tensor(x) and i != SHARED_ARG.get(name) else x
                for i, x in enumerate(args)]

    def outputs(fn, name, args, kw=None, mcfg=None):
        """fn on fresh clones: what it returns, then the tensors it
        updates in place."""
        a = fresh(name, args)
        out = call(fn, name, a, kw, mcfg)
        return list(out or ()) + [a[i] for i in INPLACE.get(name, ())]

    def compare(name, args, kw=None, mcfg=None, errs=None):
        """The kernel (through its wrapper) against the plain version on
        the same card tensors; returns the kernel's outputs. The largest
        difference goes to `errs` (the solo record `max_err` unless a
        batched phase names its own)."""
        errs = max_err if errs is None else errs
        got = outputs(wrapper_of(name), name, args, kw, mcfg)
        want = outputs(plain_of(name), name, args, kw, mcfg)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                fail(f"{name}: the kernel and its plain version return different outputs")
            if g is not None and not torch.equal(g, w):
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        errs[name] = max(errs.get(name, 0), err)
        if err != 0:
            fail(f"{name}: kernel differs from its plain version by {err}")
        return got

    # ---- 3. kernels on random inputs at the main paths' shapes
    rng = np.random.default_rng(2026)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def words(shape):  # random 32-bit words, about half with bit 31 set
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)

    def probe_np(mcfg, g):
        """Random probe inputs at mcfg's shapes, as numpy, from generator
        `g`: a pool of random directory rows (the last row among them)
        that the pointers and home slots name, the home slots from 256 of
        them, so rows are shared. Also the live group-bit copies whose
        fill-time epoch differs from their entry's (0 on a full map)."""
        C, S1, W1 = mcfg.n_cores, mcfg.l1.sets, mcfg.l1.ways
        W2, NW = mcfg.llc.ways, mcfg.n_sharer_words
        MW, DW, FS = llc_meta_width(mcfg), dirm_width(mcfg), W1 * S1
        NS, rl = mcfg.n_banks * mcfg.llc.sets, mcfg.local_run_len
        n_lines = 6
        pool = np.append(g.choice(NS - 1, min(8191, NS - 1), replace=False), NS - 1)
        prow = g.integers(0, len(pool), (C, W1))
        ptr = pool[prow] * W2 + g.integers(0, W2, (C, W1))
        slot = pool[g.integers(len(pool) - 256, len(pool), C)]
        line = g.integers(0, n_lines, C)
        cols = np.arange(W1)[None, :] * S1 + (line & (S1 - 1))[:, None]
        l1 = np.concatenate([
            g.integers(-1, n_lines, (C, FS)), g.integers(0, 4, (C, FS)),
            g.integers(0, 4, (C, FS)), g.integers(0, NS * W2, (C, FS)),
            g.integers(0, 3, (C, FS)),
        ], axis=1)
        l1[np.arange(C)[:, None], 3 * FS + cols] = ptr
        rows = np.zeros((len(pool), DW), np.int64)
        rows[:, 0 : 2 * W2 : 2] = g.integers(-1, n_lines, (len(pool), W2))
        rows[:, 1 : 2 * W2 : 2] = g.integers(-1, C, (len(pool), W2))
        rows[:, 2 * W2 : 4 * W2] = g.integers(0, 3, (len(pool), 2 * W2))
        rows[:, MW:] = g.integers(0, 2**32, (len(pool), W2 * NW),
                                  dtype=np.uint64).astype(np.uint32).view(np.int32)
        at = {r: i for i, r in enumerate(pool)}
        cc, ww = np.nonzero(g.random((C, W1)) < 0.5)  # live copies, a third owned
        for c, w in zip(cc, ww):
            i, pway = at[ptr[c, w] // W2], ptr[c, w] % W2
            rows[i, 2 * pway] = l1[c, cols[c, w]]
            if g.random() < 0.3:
                rows[i, 2 * pway + 1] = c
        mismatched = 0
        if mcfg.sharer_group > 1:  # group-bit copies whose epoch moved on
            i = np.vectorize(at.get)(ptr // W2)
            pway = ptr % W2
            gr = (np.arange(C) >> (mcfg.sharer_group.bit_length() - 1))[:, None]
            word = rows[i, MW + pway * NW + (gr >> 5)] & 0xFFFFFFFF
            rc = np.arange(C)[:, None]
            mismatched = int((
                (l1[rc, FS + cols] != 0) & (rows[i, 2 * pway] == l1[rc, cols])
                & (rows[i, 2 * pway + 1] != rc) & (((word >> (gr & 31)) & 1) != 0)
                & (rows[i, 3 * W2 + pway] != l1[rc, 4 * FS + cols])
            ).sum())
        run_cols = np.where(g.random((C, rl)) < 0.5,
                            g.integers(0, W1, (C, rl)) * S1 + (line & (S1 - 1))[:, None],
                            g.integers(0, FS, (C, rl)))
        hm, wm = g.random((C, rl)) < 0.5, g.random((C, rl)) < 0.5
        return dict(l1=l1, pool=pool, rows=rows, slot=slot, line=line,
                    run_cols=run_cols, hm=hm, wm=wm, mismatched=mismatched)

    def commit_np(mcfg, g, p, pc_lanes):
        """Random commit lanes for a probe's inputs `p` and output lanes,
        then a random L1, counters and counter deltas (the full int32
        range: the fold must wrap)."""
        C, W1, FS = mcfg.n_cores, mcfg.l1.ways, mcfg.l1.ways * mcfg.l1.sets
        flags = g.integers(0, 2, (C, 18))
        lanes = np.stack([
            p["line"], g.integers(0, W1, C), g.integers(0, W1, C), *flags[:, 3:9].T,
            g.integers(0, 4, C), p["slot"], pc_lanes[:, step_kernels.PL_LLC_HWAY],
            pc_lanes[:, step_kernels.PL_LLC_VWAY], *flags[:, 13:17].T,
            g.integers(0, C, C),
        ], axis=1)
        l1 = g.integers(-5, 50, (C, 5 * FS))
        counters = g.integers(-(2**31), 2**31, (26, C), dtype=np.int64)
        return lanes, l1, counters, g.integers(0, 2**30, (26, C))

    def probe_bit31(lanes, shw):
        """GETS-probe winners whose row's old sharer words hold bit 31
        (MOESI keeps those bits)."""
        old_bit31 = (shw < 0).any(-1).cpu().numpy()
        return int((
            (lanes[..., step_kernels.CL_WINNER] != 0) & (lanes[..., step_kernels.CL_LLC_HIT] != 0)
            & (lanes[..., step_kernels.CL_GETS_PROBE] != 0) & old_bit31).sum())

    def step_kernels_random(mcfg):
        """probe_classify, then commit_step on its outputs, on random
        inputs at mcfg's shapes (`probe_np`, `commit_np`): the full-size
        directory, zero but for the pool. Returns the live group-bit
        copies whose fill-time epoch differs from their entry's (0 on a
        full map) and the GETS-probe winners whose row's old sharer words
        hold bit 31."""
        NS, DW = mcfg.n_banks * mcfg.llc.sets, dirm_width(mcfg)
        p = probe_np(mcfg, rng)
        if mcfg.sharer_group > 1 and not p["mismatched"]:
            fail("kernels: no group-bit copy meets a changed epoch")
        dirm = torch.zeros(NS, DW, dtype=torch.int32, device=dev)
        dirm[torch.from_numpy(p["pool"]).to(dev)] = cu(p["rows"])
        patch = [torch.from_numpy(p["hm"]).to(dev), torch.from_numpy(p["wm"]).to(dev),
                 cu(p["run_cols"])]
        cid = cu(np.arange(mcfg.n_cores))
        step_no = torch.tensor(777, dtype=torch.int32, device=dev)
        pc_out = compare("probe_classify", [
            cu(p["l1"]), dirm, cu(p["slot"]), cu(p["line"]), cid, step_no, *patch,
        ], mcfg=mcfg)
        lanes, l1, counters, delta = commit_np(mcfg, rng, p, pc_out[5].cpu().numpy())
        compare("commit_step", [
            cu(l1), dirm, pc_out[0], pc_out[3], pc_out[4], cu(lanes), pc_out[5], cid,
            step_no, cu(counters), cu(delta), *patch,
        ], mcfg=mcfg)
        bit31 = probe_bit31(lanes, pc_out[3])
        del dirm, pc_out
        torch.cuda.empty_cache()
        return p["mismatched"], bit31

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

    # ---- 3b. the kernels batched: one launch for B elements of one
    # geometry, each with its own inputs and latency knobs, against the
    # batched plain versions; element B-1's last core homes at the last
    # directory row, and one element has no active row
    rng_b = np.random.default_rng(2029)
    max_err_b = {k: 0 for k in wrappers}
    FB = len(FLEET_LATS)

    def lat_pair(n):  # each element's own link and router latency, [n] each
        lat = np.asarray(FLEET_LATS[:n], np.int32)
        return cu(lat[:, 0]), cu(lat[:, 1])

    NSh = cfg.n_banks * cfg.llc.sets
    ps = [probe_np(cfg, rng_b) for _ in range(FB)]
    ps[-1]["slot"][-1] = NSh - 1
    dirm_b = torch.zeros(FB, NSh, DW, dtype=torch.int32, device=dev)
    for b, p in enumerate(ps):
        dirm_b[b, torch.from_numpy(p["pool"]).to(dev)] = cu(p["rows"])

    def stacked(key):
        return cu(np.stack([p[key] for p in ps]))

    patch_b = [torch.from_numpy(np.stack([p[k] for p in ps])).to(dev) for k in ("hm", "wm")]
    patch_b.append(stacked("run_cols"))
    cid_h = cu(np.arange(C))
    steps_b = cu(rng_b.integers(0, 5000, FB))
    pc_b = compare("probe_classify", [stacked("l1"), dirm_b, stacked("slot"), stacked("line"),
                                      cid_h, steps_b, *patch_b], errs=max_err_b)
    cm = [commit_np(cfg, rng_b, p, pc_b[5][b].cpu().numpy()) for b, p in enumerate(ps)]
    lanes_b = np.stack([c[0] for c in cm])
    lanes_b[1, :, [step_kernels.CL_WINNER, step_kernels.CL_JOIN]] = 0  # nothing commits
    compare("commit_step", [
        cu(np.stack([c[1] for c in cm])), dirm_b, pc_b[0], pc_b[3], pc_b[4], cu(lanes_b),
        pc_b[5], cid_h, steps_b, cu(np.stack([c[2] for c in cm])),
        cu(np.stack([c[3] for c in cm])), *patch_b], errs=max_err_b)
    del dirm_b, pc_b, ps, cm
    torch.cuda.empty_cache()
    sh_b = [sharer_args(cfg) for _ in range(FB)]
    sh_b = [torch.stack([a[i] for a in sh_b]) for i in range(6)] + [cid_h, *lat_pair(FB)]
    sh_b[4][1], sh_b[5][1] = False, False  # an element with no active row
    compare("sharer_reductions", sh_b, errs=max_err_b)
    del sh_b
    router_b = {}
    for has_sync in (False, True):
        ra = [router_args(C, H3, 4 * cfg3.n_tiles, has_sync) for _ in range(FLEET_RUNG3_B)]
        ra = [torch.stack([a[i] for a in ra]) if ra[0][i] is not None else None
              for i in range(13)]
        ra[10], ra[11] = lat_pair(FLEET_RUNG3_B)
        ra[3][2] = False  # an element with no live hop
        compare("router_cascade", ra, {"has_sync": has_sync}, errs=max_err_b)
        router_b[3 if has_sync else 2] = int(ra[3].sum())
    emit({"phase": "kernels_batched", "inputs": "random", "B": {
        "probe_classify": FB, "commit_step": FB, "sharer_reductions": FB,
        "router_cascade": FLEET_RUNG3_B},
        "latencies": FLEET_LATS, "shapes": {"C": C, "NS": NSh, "DW": DW, "H": H3},
        "router_live_hops": router_b, "max_abs_err": max_err_b})

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

    # ---- the CLI's chaos mode on rung 1, on the card and on the CPU: the
    # same summary numbers and FAULTS report section
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        sched = os.path.join(tmp, "faults.json")
        with open(sched, "w") as f:
            json.dump({"events": [{"step": 5, "kind": "core_failstop", "core": 3},
                                  {"step": 2, "kind": "link_fail", "link": 4},
                                  {"step": 2, "kind": "link_degrade", "link": 9, "extra": 4}],
                       "flip_l1": 0.02, "flip_llc": 0.02, "due_rate": 0.5,
                       "due_failstop": True}, f)
        # the CLI paths of this phase, of cli_xml and of cli_sweep (printed
        # after the fleets) at once: six processes, each on its own; and
        # beside them serve_recover's daemons (no wall of theirs is a path
        # measurement; its line is printed after cli_xml's)
        recover_pool = ThreadPoolExecutor(1)
        recover_f = recover_pool.submit(serve_recover_phase, smi_line)
        with ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(cli_side_by_side, a) for a in (
                ["run", fx["config"], "--synth", "fft_like:n_phases=1,points_per_core=8,seed=3",
                 "--fold", "--fault-schedule", sched, "--fault-seed", "7",
                 "--report", os.path.join(tmp, "{device}.txt")],
                ["run", "configs/example_prime.xml", "--synth", "fft_like:n_phases=2",
                 "--fold", "--debug-invariants"],
                ["sweep", "configs/rung1_64core_fft.json", "--synth", "fft_like:n_phases=2",
                 "--fold", "--vary", "llc_lat=20", "--vary", "link_lat=2,router_lat=3",
                 "--vary", "llc_lat=20"])]
            runs, xml_runs, sweep_runs = (f.result() for f in futs)
        for d, (rc, out, err) in runs.items():
            if rc != 0:
                fail(f"cli_faults: run --device {d} exited {rc}: {err[-500:]}")
            detail = json.loads(out.strip().splitlines()[-1])["detail"]
            with open(os.path.join(tmp, f"{d}.txt")) as f:
                text = f.read()
            cli[d] = ({k: detail[k] for k in ("instructions", "max_core_cycles", "noc_msgs")},
                      text[text.index("FAULTS"):].split("\n\n")[0].splitlines())
    if cli["cuda"] != cli["cpu"]:
        fail(f"cli_faults: the card's run {cli['cuda']} != the CPU's {cli['cpu']}")
    emit({"phase": "cli_faults", "summary": cli["cuda"][0], "faults_section": cli["cuda"][1],
          "card_equals_cpu": True})

    # ---- the CLI on the reference-schema XML config with --debug-invariants,
    # on the card and on the CPU: the same summary but for the host's clock
    xml = {}
    for d, (rc, out, err) in xml_runs.items():
        if rc != 0:
            fail(f"cli_xml: run --device {d} exited {rc}: {err[-500:]}")
        xml[d] = json.loads(out.strip().splitlines()[-1])["detail"]
        xml[d] = {k: v for k, v in xml[d].items() if k not in ("wall_s", "device")}
    if xml["cuda"] != xml["cpu"]:
        fail(f"cli_xml: the card's summary {xml['cuda']} != the CPU's {xml['cpu']}")
    emit({"phase": "cli_xml", "summary": xml["cuda"], "card_equals_cpu": True})
    recover_line, recover_launches, problems = recover_f.result()
    recover_pool.shutdown()
    emit(recover_line)
    for msg in problems:
        fail(msg)

    # ---- reduced: the coarse vector and the chunked full map at 256
    # cores, card == CPU to completion
    small_tr = fold_ins(synth.fft_like(256, n_phases=8, points_per_core=16,
                                       ins_per_mem=8, seed=42))
    stream_tr = fold_ins(synth.stream(256, n_mem_ops=128, seed=42))
    rw_tr = fold_ins(synth.readers_writer(256, n_rounds=8, seed=42))
    reduced, reduced_runs = {}, {}
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
        depth = CPU_DEPTH.get(name)
        if depth:  # the CPU repeats the card's run to this depth only
            gpu.run_steps(depth)
            cut = card_cut(gpu)
        gpu.run()
        n_launch = dict(build.LAUNCHES)
        cpu, cpu_s = cpu_repeat(mcfg, rtr, 128, depth)
        for k, n in n_launch.items():
            if n != (gpu.steps_run if k in STEP_KERNELS else 0):
                fail(f"reduced {name}: {k} launched {n} times in {gpu.steps_run} steps")
        same_run(f"reduced {name}", cut if depth else gpu, cpu)
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
                         "cpu_steps": cpu.steps_run, "cpu_s": cpu_s, "launches": n_launch}
        reduced_runs[name] = (mcfg, rtr, n_launch)
        del gpu, cpu
    emit({"phase": "reduced", "card_equals_cpu": True, "machines": reduced})

    # ---- reduced fault machines at 256 cores, card == CPU to completion,
    # the fault state included: a torus whose kills leave barrier waiters
    # (relief, the drop scrub, DUE fail-stops), a ring whose kill takes a
    # lock holder (the long-way detours), rung 3's router machine (the
    # cascade and the latency order under detours)
    def fault_machine(big, topology, events, **kw):
        spec = json.loads(big.to_json())
        return MachineConfig.from_dict({
            **spec, "n_cores": 256, "n_banks": 256,
            "noc": {**spec["noc"], "mesh_x": 16, "mesh_y": 16, "topology": topology},
            "faults_enabled": True, "max_fault_events": 4, "fault_seed": 7,
            "fault_events": events, **kw})

    def state_np(eng, *fields):
        return [getattr(eng.state, f).cpu().numpy() for f in fields]

    rtk, rtc = TORUS_KILL
    rgk, rgc, rgs = RING_KILL
    fault_runs = {
        "torus_faults": (fault_machine(
            cfg, "torus", [[20, 1, 200, 0], [rtk, 1, rtc, 0]], fault_dead_policy="drop",
            fault_due_failstop=True, fault_flip_l1=1e-3, fault_due_rate=0.05),
            fold_ins(synth.barrier_phases(256, n_phases=8, work_per_phase=16, seed=42)), 32),
        "ring_faults": (fault_machine(
            cfg, "ring", [[0, 2, 68, 0], [0, 3, 161, 5], [rgk, 1, rgc, 0]]),
            fold_ins(synth.lock_contention(256, n_critical=3, n_locks=2, seed=42)), 32),
        "router_faults": (fault_machine(
            cfg3, "mesh", [[0, 2, 68, 0], [0, 2, 402, 0]], fault_flip_llc=1e-3),
            fold_ins(synth.fft_like(256, n_phases=4, points_per_core=32, ins_per_mem=8,
                                    seed=42)), 128),
    }
    faulted = {}
    for name, (mcfg, rtr, chunk) in fault_runs.items():
        gpu = Engine(mcfg, rtr, chunk_steps=chunk, device=dev)
        reset_launches()
        info = {}
        depth = CPU_DEPTH.get(name)
        if name == "torus_faults":
            gpu.run_steps(rtk)  # the state the kill step starts from
            ptr, flag = state_np(gpu, "ptr", "sync_flag")
            et = rtr.events[np.arange(256), np.minimum(ptr, rtr.max_len - 1), 0]
            waiting = (et == EV_BARRIER) & (flag == 1)
            if not waiting.any() or waiting[rtc] or et[rtc] == EV_END:
                fail(f"reduced {name}: core {rtc} is not alive and running while "
                     f"others wait at step {rtk}")
            info["waiting_at_kill"] = int(waiting.sum())
            info["barrier_waits_before_kill"] = int(gpu.counters["barrier_waits"].sum())
        elif name == "ring_faults":
            gpu.run_steps(rgk)
            if int(gpu.state.lock_holder[rgs]) != rgc:
                fail(f"reduced {name}: core {rgc} does not hold lock slot {rgs} at step {rgk}")
            gpu.run_steps(gpu.chunk_steps)  # the kill step and the rest of its chunk
            holder, dead = state_np(gpu, "lock_holder")[0], gpu.state.faults.core_dead.cpu()
            if holder[rgs] == rgc or not int(dead[rgc]):
                fail(f"reduced {name}: lock slot {rgs} still held by core {rgc} after its kill")
            info["lock_slot_after_kill"] = int(holder[rgs])
        if depth:  # the CPU repeats the card's run to this depth only
            gpu.run_steps(depth - gpu.steps_run)
            cut = card_cut(gpu)
        gpu.run()
        n_launch = dict(build.LAUNCHES)
        cpu, cpu_s = cpu_repeat(mcfg, rtr, chunk, depth)
        router = name == "router_faults"
        for k, n in n_launch.items():
            if n != (gpu.steps_run if k in STEP_KERNELS or router else 0):
                fail(f"reduced {name}: {k} launched {n} times in {gpu.steps_run} steps")
        same_run(f"reduced {name}", cut if depth else gpu, cpu)
        if not gpu.done():
            fail(f"reduced {name}: the run did not complete")
        gpu.verify_invariants()
        sums = {k: int(gpu.counters[k].sum()) for k in (
            *FAULT_COUNTERS, "barrier_waits", "lock_acquires", "noc_contention_cycles",
            "l1_writebacks")}
        if name == "torus_faults" and not (
                sums["barrier_waits"] > info["barrier_waits_before_kill"]
                and sums["core_failstops"] >= 2):
            fail(f"reduced {name}: no barrier wait after the kill, or fewer than 2 kills")
        if name != "torus_faults" and not sums["noc_reroutes"]:
            fail(f"reduced {name}: no message crossed a failed link")
        if router and not (sums["ecc_corrected"] and sums["noc_contention_cycles"]):
            fail(f"reduced {name}: no corrected LLC flip or no router contention")
        faulted[name] = {
            "steps": gpu.steps_run, "topology": mcfg.noc.topology,
            "contention_model": mcfg.noc.contention_model if mcfg.noc.contention else None,
            "dead_policy": mcfg.fault_dead_policy, "due_failstop": mcfg.fault_due_failstop,
            "dead_cores": np.flatnonzero(gpu.state.faults.core_dead.cpu().numpy()).tolist(),
            **sums, **info, "cpu_steps": cpu.steps_run, "cpu_s": cpu_s, "launches": n_launch}
        reduced_runs[name] = (mcfg, rtr, n_launch)
        del gpu, cpu
    emit({"phase": "reduced_faults", "card_equals_cpu": True, "fault_state_equal": True,
          "machines": faulted})

    # ---- 16. the sharded machine (parallel/sharding.py): SHARDS shards of
    # a tile mesh, all on this card (one card: parity, not speed), through
    # the Python API (`--devices 4` on one card is a DeviceMeshError, as in
    # JAX). sharded_headline and sharded_rung3 to their depths, each held
    # to the JAX digest there and to the unsharded port's in this call;
    # the headline's shard-0 kernel inputs of step SHARD_STAGE held to the
    # plain versions, timed alone and bounded (a "mode" line); then
    # reshard_rung2: rung 2 under RunSupervisor loses a shard and finishes
    # on the largest valid smaller mesh.
    from primesim_tpu_torch.chaos import plan as chaos_plan
    from primesim_tpu_torch.chaos import sites as chaos_sites
    from primesim_tpu_torch.parallel import sharding
    from primesim_tpu_torch.sim.supervisor import RunSupervisor

    def digest_of(eng):
        return run_digest(eng.steps_run, eng.cycles, eng.counters,
                          eng.state.link_free.cpu().numpy(), eng.state.dram_free.cpu().numpy())

    shard_staged, max_err_shard, shard_launches = {}, {}, {}

    def stage_at(name, at):
        """Keep clones of the arguments of the `at`-th call of a shard
        mode's wrapper (call s * SHARDS + k is step s's shard k)."""
        module = reductions if name == "sharer_reductions" else step_kernels
        real, calls = getattr(module, name), [0]

        def rec(mcfg, *args, **kw):
            if calls[0] == at:
                shard_staged[name] = ([x.clone() if torch.is_tensor(x) else x for x in args], kw)
            calls[0] += 1
            return real(mcfg, *args, **kw)
        setattr(module, name, rec)
        return lambda: setattr(module, name, real)

    for path, pcfg, ptrace, ran in (("sharded_headline", cfg, trace, STEP_KERNELS),
                                    ("sharded_rung3", cfg3, trace3, tuple(wrappers))):
        depth = SHARD_DEPTH[path]
        want = load_cut(f"{path}_cut", depth)["digests"][0]
        ref = Engine(pcfg, ptrace, chunk_steps=64, device=dev)
        t0 = time.perf_counter()
        ref.run_steps(depth)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref_digest = digest_of(ref)
        del ref
        torch.cuda.empty_cache()
        mesh = sharding.tile_mesh(devices=[dev] * SHARDS)
        held = torch.cuda.memory_allocated()
        eng = Engine(pcfg, ptrace, chunk_steps=64, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        undo = ([stage_at(n, SHARD_STAGE * SHARDS) for n in SHARD_MODES.values()]
                if path == "sharded_headline" else [])
        reset_launches()
        sharding.reset_moves()
        t0 = time.perf_counter()
        try:
            eng.run_steps(depth)
            torch.cuda.synchronize()
        finally:
            for u in undo:
                u()
        wall = time.perf_counter() - t0
        n_launch = shard_launches[path] = dict(build.LAUNCHES)
        moves = {k: dict(v) for k, v in sharding.MOVES.items()}
        peak = torch.cuda.max_memory_allocated() - held
        got, steps = digest_of(eng), eng.steps_run
        for k, n in n_launch.items():
            if n != ((SHARDS if k in STEP_KERNELS else 1) * steps if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {steps} steps on {SHARDS} shards")
        for k, v in want.items():
            if got[k] != v:
                fail(f"{path}: {k} {got[k]} != the JAX package's {v} at step {depth}")
        if got != ref_digest:
            fail(f"{path}: the sharded digest differs from the unsharded port's")
        syncs = None
        if path == "sharded_headline":  # 64 more steps under CUDA's sync debug mode
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run_chunk(pcfg, 64, eng.events, eng.state, eng.has_sync)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            syncs = [str(w.message)[:200] for w in caught if "synchroniz" in str(w.message)
                     and "prototype feature" not in str(w.message)]
            if syncs:
                fail(f"{path}: {len(syncs)} synchronising calls in 64 sharded steps: {syncs[:3]}")

        def per_step(names):
            return sum(moves[n]["bytes"] for n in names if n in moves) / steps

        emit({"phase": path, "shards": SHARDS, "mesh_ids": mesh.ids, "steps": steps,
              "chunk_steps": 64, "wall_s": wall, "simulated_mips": got["instructions"] / wall / 1e6,
              "unsharded_wall_s": ref_s, "peak_memory_bytes": peak, "launches": n_launch,
              "launches_per_step": {k: n / steps for k, n in n_launch.items()},
              "staged_in_bytes_per_step": per_step(("probe.vrows", "probe.mrows", "run.rows")),
              "delta_out_bytes_per_step": per_step(("commit.rows",)),
              "moved_bytes_per_step": per_step(moves),
              "moves": {k: {"per_step": m["moves"] / steps, "bytes_per_step": m["bytes"] / steps,
                            "largest": m["shape"]} for k, m in sorted(moves.items())},
              "directory_bytes": sum(p.numel() * p.element_size() for p in eng.state.dirm),
              "instructions": got["instructions"], "max_core_cycles": got["max_core_cycles"],
              "syncs_in_64_steps": None if syncs is None else len(syncs),
              "equals_jax_digest": True, "equals_unsharded_port": True, "gpu": smi_line})
        del eng
        torch.cuda.empty_cache()

    sharding.virtual_devices(SHARDS, dev)  # SHARDS ids on this card: one can be lost
    try:
        with tempfile.TemporaryDirectory() as tmp:
            eng = Engine(cfg2, trace2, chunk_steps=RESHARD_CHUNK, mesh=sharding.tile_mesh(SHARDS))
            sup = RunSupervisor(eng, snapshot_dir=os.path.join(tmp, "snaps"),
                                checkpoint_every_chunks=1, handle_signals=False)
            chaos_sites.install(chaos_plan.FaultPlan(seed=0, events=(chaos_plan.FaultEvent(
                site="devices.revoke", occurrence=RESHARD_AT, action="revoke",
                args=(("n", 1),)),)))
            reset_launches()
            t0 = time.perf_counter()
            try:
                sup.run()
                torch.cuda.synchronize()
            finally:
                chaos_sites.deactivate()
            wall = time.perf_counter() - t0
            n_launch = shard_launches["reshard_rung2"] = dict(build.LAUNCHES)
            got, steps, to = digest_of(eng), eng.steps_run, eng.mesh.size
    finally:
        sharding.restore_devices()
        sharding.virtual_devices(None)
    before = RESHARD_CHUNK * (RESHARD_AT - 1)  # on SHARDS shards, then `to` from the snapshot
    if sup.degrade_rungs != [f"reshard:{SHARDS}->2"] or to != 2:
        fail(f"reshard_rung2: degrade rungs {sup.degrade_rungs}, mesh of {to}")
    for k, n in n_launch.items():
        if n != (SHARDS * before + to * (steps - before) if k in STEP_KERNELS else 0):
            fail(f"reshard_rung2: {k} launched {n} times")
    for k, v in r2fx["digest"].items():
        if k != "steps" and got[k] != v:  # the chunk of 128 may stop short of 512's
            fail(f"reshard_rung2: {k} {got[k]} != the JAX package's {v}")
    emit({"phase": "reshard_rung2", "shards": SHARDS, "to_shards": to,
          "degrade_rungs": sup.degrade_rungs, "summary": sup.summary(),
          "log": sup.log_lines(), "steps": steps, "chunk_steps": RESHARD_CHUNK,
          "revoked_at_chunk_boundary": RESHARD_AT, "wall_s": wall, "launches": n_launch,
          "equals_jax_digest": True, "gpu": smi_line})
    del eng, sup
    torch.cuda.empty_cache()

    pool_launches = {}
    for f in pool_fs + calib_fs:
        pool_lines, launches_of = f.result()  # a failure there exits here
        pool_launches.update(launches_of)
        for line in pool_lines:
            emit(line)
    pool_ex.shutdown()
    calib_ex.shutdown()

    # ---- 5. capture: the first chunk of each main path, card == CPU, and
    # the kernel inputs it stages
    staged = {k: {} for k in wrappers}

    def recorder(name, steps):
        real = wrappers[name]
        calls = [0]

        def rec(*args, **kw):
            if calls[0] in steps:
                a = solo_args(name, args[1:] if name in STEP_KERNELS else args)
                staged[name][calls[0]] = (
                    [x.clone() if torch.is_tensor(x) else x for x in a], kw)
            calls[0] += 1
            return real(*args, **kw)
        return rec

    check_s = {}
    for path, pcfg, ptr, names, cut_fx in (
            ("headline", cfg, trace, STEP_KERNELS, "headline_cut"),
            ("rung3", cfg3, trace3, RUNG3_STAGED, "rung3_headline_cut")):
        for k in names:
            setattr(mods[k], k, recorder(k, CAPTURE[path]))
        try:
            gpu = Engine(pcfg, ptr, chunk_steps=64, device=dev)
            gpu.run_steps(CHECK_CPU_STEPS)
            cut = card_cut(gpu)
            gpu.run_steps(CHECK_STEPS - CHECK_CPU_STEPS)
        finally:
            for k in names:
                setattr(mods[k], k, wrappers[k])
        cpu, check_s[path] = cpu_repeat(pcfg, ptr, 64, CHECK_CPU_STEPS)
        cs = same_run(f"capture {path}", cut, cpu)
        if run_digest(cut.steps_run, cut.cycles, cut.counters, cs["link_free"],
                      cs["dram_free"]) != load_cut(cut_fx, CHECK_CPU_STEPS)["digests"][0]:
            fail(f"capture {path}: the card's digest at step {CHECK_CPU_STEPS} is not "
                 f"the JAX package's ({cut_fx}.json)")
        del gpu, cpu
        for k in names:
            if set(staged[k]) != set(CAPTURE[path]):
                fail(f"capture: {k} staged inputs of steps {sorted(staged[k])} only")
            for args, kw in staged[k].values():
                compare(k, args, kw)

    timed_step = {k: CAPTURE["rung3" if k in RUNG3_STAGED else "headline"][-1]
                  for k in wrappers}

    captured = {k: staged[k][timed_step[k]] for k in wrappers}

    def dirm_rows(a):
        """The directory rows commit_step may change (its lanes' slots) as
        rows of the directory viewed [B*NS, DW] (a solo [NS, DW] is B = 1)."""
        lanes, NS = a[5], a[1].shape[-2]
        slot = lanes[..., step_kernels.CL_SLOT].long()
        if lanes.dim() == 3:  # batched: element b's rows start at b*NS
            slot = slot + torch.arange(lanes.shape[0], device=dev)[:, None] * NS
        return torch.unique(slot.flatten())

    def timed_call(k, args, kw, mcfg=None):
        """(launch, prep): one wrapper call on a step's staged inputs, and
        what restores the tensors it updates in place beforehand (outside
        the timed window). commit_step changes only the directory rows its
        lanes name (column CL_SLOT), so only those rows are restored: a
        copy of the whole directory would leave L2 full of dirty lines."""
        work = fresh(k, args)
        pairs = []
        for i in INPLACE.get(k, ()):
            if (k, i) == ("commit_step", 1):
                rows = dirm_rows(args)
                flat = work[i].view(-1, work[i].shape[-1])
                pairs.append((flat, rows, flat[rows].clone()))
            else:
                pairs.append((work[i], None, args[i]))

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
        """(device events of fn() as sorted (start, end, name) in µs, fn's
        wall seconds, and with `by_op` the 16 torch operators, by input
        shapes, whose own kernels took the most device time) under
        torch.profiler, read from its raw events (`ops_by_shape`). A random
        fill, which the simulator never makes, marks where fn begins: the
        trace may still hold kernels that ran before the profile did."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=by_op) as prof:
            time.sleep(0.2)  # let the tracer settle before the marker
            torch.randn(1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        raw = prof.profiler.kineto_results.events()
        demangle = torch._C._demangle
        cpu_ev = [e for e in raw if e.device_type() == DeviceType.CPU]
        gpu_ev = [e for e in raw if e.device_type() == DeviceType.CUDA]
        begin = min(e.start_ns() for e in cpu_ev if e.name() == "aten::randn")
        dev_ev = sorted(
            ((e.start_ns() - begin) / 1e3, (e.end_ns() - begin) / 1e3, demangle(e.name()))
            for e in gpu_ev if e.start_ns() >= begin
        )
        if dev_ev and "normal" in dev_ev[0][2]:
            dev_ev = dev_ev[1:]  # the marker's own kernel
        ops = ops_by_shape(cpu_ev, gpu_ev, demangle)[:16] if by_op else None
        return dev_ev, wall_s, ops

    def time_alone(k, args, kw, mcfg=None):
        """The kernel's and its plain version's event times on staged
        inputs."""
        launch, prep = timed_call(k, args, kw, mcfg)
        return {
            "ms": device_ms(lambda: launch(wrapper_of(k)), 4_000_000, prep),
            "plain_ms": device_ms(lambda: launch(plain_of(k)), 100_000_000, prep),
        }

    timing = {k: time_alone(k, *captured[k]) for k in wrappers}
    event_floor_ms = device_ms(lambda: torch.cuda._sleep(0), 4_000_000)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


    # the bytes each function needs on a step's inputs, as the main path
    # stages them: every word it reads, once, and every output word, once
    def probe_bound(a, mcfg):  # l1 dirm slot line cid step hm wm cm
        # C counts the lanes of every element: B*C for a batch
        C, W1, W2, NW = a[2].numel(), mcfg.l1.ways, mcfg.llc.ways, mcfg.n_sharer_words
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
        C, NW = a[5][..., 0].numel(), mcfg.n_sharer_words  # lanes of every element
        new_l1, new_dirm, _ = outputs(wrappers["commit_step"], "commit_step", a, mcfg=mcfg)
        rows = dirm_rows(a)  # all it may change
        DW = a[1].shape[-1]
        l1_words = int((new_l1 != a[0]).sum())
        dirm_words = int((new_dirm.view(-1, DW)[rows] != a[1].view(-1, DW)[rows]).sum())
        del new_l1, new_dirm
        win = a[5][..., step_kernels.CL_WINNER] != 0
        n_win = int(win.sum())
        n_join = int(((a[5][..., step_kernels.CL_JOIN] != 0) & ~win).sum())
        b = (4 * (l1_words + dirm_words)
             + 3 * nbytes(a[9])  # counters in and out, delta in
             + nbytes(a[2], a[5], *a[7:9], *a[11:])  # tag rows, lanes, cid, step, patch
             + 4 * C * 8  # the home-row words of the probe's lanes
             + 4 * (n_win * NW + n_join))  # old sharer words, a joiner's own word
        return b, {"bytes": b, "winners": n_win, "joiners": n_join,
                   "words_changed": {"l1": l1_words, "dirm": dirm_words}}

    def set_bits(words, rows, n_bits):
        """[rows, 32*NW] bool: the set bits below n_bits of the rows' words."""
        t = torch.arange(32 * words.shape[-1], device=dev)
        bits = ((words[rows][:, t >> 5] >> (t & 31)) & 1) != 0
        return bits & (t < n_bits)

    def sharer_bound(a, kw, mcfg):
        """Both flag bytes of every row, the lanes and sharer words of the
        active rows, the outputs; per set bit of those words, the full map
        computes a hop count, the group mode reads table words (memb[g]
        and the home tile's max and summed hops, each distinct word
        once)."""
        # shw vic_shw btile vic_owner inv_row vic_valid cid link router
        C, NW = mcfg.n_cores, mcfg.n_sharer_words  # C: each element's cores
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
             + 4 * 5 * irow.numel())  # the five outputs
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
    def cascade_bound(a, kw):
        """((ms, "bytes" or "operations"), detail, bytes) of router_cascade
        on staged inputs: the live hops' route, clock, base, rank and
        departure, every hop's mask byte, the per-core words."""
        # lf base pth ok r t0 service hops x3 link router out
        ok = a[3].reshape(-1, a[3].shape[-1])  # the lanes of every element
        n, legs = ok.shape[0], 3 if kw["has_sync"] else 2
        n_ok = int(ok.sum())
        b = (ok.numel()  # every hop's mask byte
             + 4 * 4 * n_ok  # route, link clock, base and rank of the live hops
             + 8 * n_ok  # read-modify-write of each live hop's departure
             + 4 * n * (2 + legs) + nbytes(a[10], a[11])  # t0, service, hops, latencies
             + 4 * n * (legs - 1))  # the reply (and arrival) leg's end out
        # floor 4, offset 2, running max 1, departure 4 per live hop; the
        # masked hops' SENT offsets and running max, 2 each
        ops = 11 * n_ok + 2 * (ok.numel() - n_ok)
        info = {"legs": legs, "live": n_ok, "all": ok.numel(), "ops": ops,
                "live_by_leg": [int(x) for x in ok.view(n, legs, -1).sum((0, 2))]}
        return max((b / HBM_BYTES_PER_S * 1e3, "bytes"),
                   (ops / INT_OPS_PER_S * 1e3, "operations")), info, b

    a, kw = staged["router_cascade"][CAPTURE["rung3"][-1]]
    cas_bound, cas_info, cas_bytes = cascade_bound(a, kw)
    bounds = {k: step_bounds[k][0] for k in STEP_KERNELS}
    bounds["router_cascade"] = cas_bound
    capture_line = {"phase": "capture", "steps": CAPTURE, "timed_step": timed_step,
          "card_equals_cpu_steps": CHECK_CPU_STEPS, "cpu_s": check_s,
          "card_equals_jax_cut": ["headline_cut", "rung3_headline_cut"],
          "max_abs_err": max_err, "timing_ms": timing,
          "event_floor_ms": event_floor_ms, "profiler_reps": PROF_REPS,
          "bytes": {**{k: step_bounds[k][2] for k in STEP_KERNELS},
                    "router_cascade": cas_bytes},
          "commit": step_bounds["commit_step"][1],
          "sharer_rows": step_bounds["sharer_reductions"][1],
          "router_hops": {k: cas_info[k] for k in ("legs", "live", "live_by_leg", "all")},
          "gpu": smi_line}
    del staged  # the other staged steps, before the main paths' peaks

    # ---- 16, continued: the shard-0 kernel inputs of the sharded
    # headline's step SHARD_STAGE, each mode alone against its plain
    # version, timed by events and bounded (a "mode" line)
    def shard_bound(k, a, kw, mcfg):
        """((ms, bound_by), detail, bytes) of a shard mode on its staged
        inputs, counted as the whole-directory modes are: every word it
        needs read once, every word it writes once."""
        if k == "sharer_reductions":
            return sharer_bound(a, kw, mcfg)
        W1, W2, NW = mcfg.l1.ways, mcfg.llc.ways, mcfg.n_sharer_words
        if k == "probe_classify":  # l1 vrows mrows line cid step hm wm cm
            C = a[3].numel()
            coarse = mcfg.sharer_group > 1
            b = (4 * C * (4 * W1 + 3 * W1 + (2 * W1 if coarse else 0) + 2 * W2 + 4 + 2 * NW)
                 + nbytes(*a[3:])
                 + 4 * C * (3 * W1 + 2 * NW + step_kernels.PROBE_LANES))
            return (b / HBM_BYTES_PER_S * 1e3, "bytes"), {"bytes": b, "lanes": C}, b
        # l1 tag shw vic_shw lanes pc cid step counters delta hm wm cm
        C = a[4][..., 0].numel()
        rows, _, new_l1, _ = outputs(wrapper_of("commit_step_rows"), "commit_step_rows", a,
                                     mcfg=mcfg)
        l1_words, row_words = int((new_l1 != a[0]).sum()), int((rows != 0).sum())
        win = a[4][..., step_kernels.CL_WINNER] != 0
        n_win = int(win.sum())
        n_join = int(((a[4][..., step_kernels.CL_JOIN] != 0) & ~win).sum())
        b = (4 * (l1_words + row_words + C)  # L1 words, delta words, target slots
             + 3 * nbytes(a[8])  # counters in and out, delta in
             + nbytes(a[1], a[4], *a[6:8], *a[10:])  # tag rows, lanes, cid, step, patch
             + 4 * C * 8  # the home-row words of the probe's lanes
             + 4 * (n_win * NW + n_join))  # old sharer words, a joiner's own word
        return (b / HBM_BYTES_PER_S * 1e3, "bytes"), {
            "bytes": b, "winners": n_win, "joiners": n_join,
            "words_written": {"l1": l1_words, "delta_rows": row_words}}, b

    shard_mode = {}
    for k, name in SHARD_MODES.items():
        if name not in shard_staged:
            fail(f"sharded_headline: {name}'s inputs of step {SHARD_STAGE} were not staged")
        args, kw = shard_staged[name]
        compare(name, args, kw, mcfg=cfg, errs=max_err_shard)
        bnd, info, nb = shard_bound(k, args, kw, cfg)
        shard_mode[k] = {"mode": name, **time_alone(name, args, kw, cfg),
                         "launches": shard_launches["sharded_headline"][k],
                         "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": nb, "detail": info,
                         "max_abs_err": max_err_shard[name], "lanes": cfg.n_cores // SHARDS}
    shard_staged.clear()
    torch.cuda.empty_cache()
    emit({"phase": "mode", "path": "sharded_headline", "shard": 0, "staged_step": SHARD_STAGE,
          "kernels": shard_mode, "max_abs_err": max_err_shard,
          "event_floor_ms": event_floor_ms, "gpu": smi_line})

    # ---- 6./7. the main paths, each with the counts set to 0 just before
    launches = {}
    main_paths = [("headline", cfg, hfx, trace, STEP_KERNELS),
                  ("rung3", cfg3, r3fx, trace3, tuple(wrappers))]
    main_paths += [(path, fxs[path][1], fxs[path][0], fxs[path][2], STEP_KERNELS)
                   for fxs, paths in ((large, LARGE), (zoo, ZOO)) for path, _ in paths]
    main_paths.append(("headline_faults", cfg_hf, hffx, trace_hf, STEP_KERNELS))
    main_paths.append(("rung2", cfg2, r2fx, trace2, STEP_KERNELS))
    sums_of, baselines = {}, {}
    real_scrub = inject.scrub_dead
    scrubs = []

    def counted_scrub(*args):  # host-side count of the steps that scrub
        scrubs.append(1)
        return real_scrub(*args)

    for path, pcfg, fx, ptrace, ran in main_paths:
        held = torch.cuda.memory_allocated()  # the timed step's inputs, kept for phase 8
        eng = Engine(pcfg, ptrace, chunk_steps=fx["chunk_steps"], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        scrubs.clear()
        inject.scrub_dead = counted_scrub
        cut_of = MAIN_CUT.get(path)
        t0 = time.perf_counter()
        try:
            eng.run_steps(cut_of[1]) if cut_of else eng.run()
            torch.cuda.synchronize()
        finally:
            inject.scrub_dead = real_scrub
        wall = time.perf_counter() - t0
        if cut_of:  # held to the JAX digest at the cut
            fx = {**fx, "digest": load_cut(*cut_of)["digests"][0]}
        launches[path] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
        baselines[path] = {"wall_s": wall, "peak_memory_bytes": peak}
        got = run_digest(eng.steps_run, eng.cycles, eng.counters,
                         eng.state.link_free.cpu().numpy(),
                         eng.state.dram_free.cpu().numpy())
        ins = got["instructions"]
        sums = sums_of[path] = got["counter_sums"]
        fault_info = {"faults": {
            **{k: sums[k] for k in (*FAULT_COUNTERS, "l1_writebacks")},
            "dead_cores": np.flatnonzero(eng.state.faults.core_dead.cpu().numpy()).tolist(),
            "scrub_steps": len(scrubs)}} if pcfg.faults_enabled else {}
        emit({"phase": path, "steps": eng.steps_run, "wall_s": wall, **fault_info,
              "simulated_mips": ins / wall / 1e6, "peak_memory_bytes": peak,
              "launches": launches[path], "instructions": ins,
              "max_core_cycles": got["max_core_cycles"],
              "noc_msgs": sums["noc_msgs"],
              "noc_contention_cycles": sums["noc_contention_cycles"],
              "dram_queue_cycles": sums["dram_queue_cycles"],
              **{k: sums[k] for k in ("probes", "barrier_waits", "prefetch_hits")},
              "digest": {k: v for k, v in got.items() if k.endswith("sha256")},
              "equals_jax_digest": got == fx["digest"],
              "cut": list(cut_of) if cut_of else None, "gpu": smi_line})
        for k, n in launches[path].items():
            if n != (eng.steps_run if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {eng.steps_run} steps")
        if not (pcfg.faults_enabled or cut_of) and ins != ptrace.total_instructions():
            fail(f"{path}: {ins} instructions retired, trace has {ptrace.total_instructions()}")
        if pcfg.faults_enabled and not all(sums[k] for k in FAULT_COUNTERS):
            fail(f"{path}: a fault counter sums to 0: {fault_info}")
        if pcfg.faults_enabled and not 0 < len(scrubs) < eng.steps_run // 16:
            fail(f"{path}: the scrub ran on {len(scrubs)} of {eng.steps_run} steps")
        for k, want in fx["digest"].items():
            if got[k] != want:
                fail(f"{path}: {k} {got[k]} != the JAX package's {want}")
        if not (cut_of or eng.done()):
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

    # ---- multiprog_rung3: four 256-core programs (an FFT, barriers, locks,
    # a reader-writer), written as PTPU files by the port's synth verb and
    # multiplexed into rung 3 by the CLI's loader; run with the flight
    # recorder to step MP_CUT, checkpointed, freed, resumed in a fresh
    # engine and run to the end. Then the same programs through the CLI.
    mp_dir = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        mp_paths = []
        for i, prog in enumerate(mpfx["trace"]["multiplex"]):
            args = dict(prog["args"])
            n = args.pop("n_cores")
            mp_paths.append(os.path.join(mp_dir, f"prog{i}.ptpu"))
            spec = prog["generator"] + ":" + ",".join(f"{k}={v}" for k, v in args.items())
            if tcli.main(["synth", spec, "--cores", str(n), "--out", mp_paths[-1]]) != 0:
                fail(f"multiprog_rung3: synth {spec} failed")
        mp_tr = tcli._load_trace(
            SimpleNamespace(trace=mp_paths, synth=None, fold=mpfx["trace"]["fold"]),
            cfg_mp.n_cores, line_bits=cfg_mp.line_bits)
        if mp_tr.events.tobytes() != trace_mp.events.tobytes():
            fail("multiprog_rung3: the CLI's multiplexed trace is not the fixture's")
        rec = Recorder("full")
        held = torch.cuda.memory_allocated()
        eng = Engine(cfg_mp, mp_tr, chunk_steps=mpfx["chunk_steps"], device=dev)
        if not eng.has_sync:
            fail("multiprog_rung3: the trace has no sync events")
        rec.attach(eng)
        real_cascade, with_sync = router_kernels.router_cascade, [0]

        def cascade_counted(*args, **kw):  # host-side count of three-leg calls
            with_sync[0] += bool(kw.get("has_sync"))
            return real_cascade(*args, **kw)

        ck = os.path.join(mp_dir, "mid.npz")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        router_kernels.router_cascade = cascade_counted
        try:
            t0 = time.perf_counter()
            eng.run_steps(MP_CUT)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            eng.save_checkpoint(ck)
            save_s = time.perf_counter() - t0
            del eng
            torch.cuda.empty_cache()
            eng = Engine(cfg_mp, mp_tr, chunk_steps=mpfx["chunk_steps"], device=dev)
            t0 = time.perf_counter()
            eng.load_checkpoint(ck)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if eng.steps_run != MP_CUT:
                fail(f"multiprog_rung3: resumed at step {eng.steps_run}, not {MP_CUT}")
            rec.attach(eng)
            t0 = time.perf_counter()
            eng.run_steps(MP_DEPTH - MP_CUT)
            torch.cuda.synchronize()
            rest_s = time.perf_counter() - t0
        finally:
            router_kernels.router_cascade = real_cascade
        launches["multiprog_rung3"] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
        got = run_digest(eng.steps_run, eng.cycles, eng.counters,
                         eng.state.link_free.cpu().numpy(), eng.state.dram_free.cpu().numpy())
        mp_cut = load_cut("multiprog_rung3_cut", MP_DEPTH)["digests"][0]
        sums = got["counter_sums"]
        samples = rec.store.samples()
        spans = [e for e in rec.trace.events if e["ph"] == "B" and e["name"] == "chunk"]
        n_chunks = eng.steps_run // eng.chunk_steps
        mean_phases = {k: float(np.mean([x["phases"][k] for x in samples]))
                       for k in ("dispatch", "drain", "rebase")}
        emit({"phase": "multiprog_rung3", "steps": eng.steps_run, "checkpoint_step": MP_CUT,
              "wall_s": first_s + rest_s, "wall_s_before_after": [first_s, rest_s],
              "simulated_mips": got["instructions"] / (first_s + rest_s) / 1e6,
              "checkpoint_bytes": os.path.getsize(ck), "save_s": save_s, "load_s": load_s,
              "peak_memory_bytes": peak, "launches": launches["multiprog_rung3"],
              "router_cascade_with_sync": with_sync[0], "instructions": got["instructions"],
              "max_core_cycles": got["max_core_cycles"],
              **{k: sums[k] for k in ("noc_msgs", "lock_acquires", "barrier_waits",
                                      "noc_contention_cycles", "dram_queue_cycles")},
              "recorder": {"chunks": len(samples), "spans": len(spans),
                           "mean_phase_s": mean_phases},
              "digest": {k: v for k, v in got.items() if k.endswith("sha256")},
              "depth": MP_DEPTH, "equals_jax_digest": got == mp_cut, "gpu": smi_line})
        for k, n in launches["multiprog_rung3"].items():
            if n != eng.steps_run:
                fail(f"multiprog_rung3: {k} launched {n} times in {eng.steps_run} steps")
        if with_sync[0] != eng.steps_run:
            fail(f"multiprog_rung3: router_cascade ran {with_sync[0]} of "
                 f"{eng.steps_run} steps with the barrier-arrival leg")
        for k, want in mp_cut.items():
            if got[k] != want:
                fail(f"multiprog_rung3: {k} {got[k]} != the JAX package's {want} at "
                     f"step {MP_DEPTH}")
        if not (sums["lock_acquires"] and sums["barrier_waits"]):
            fail("multiprog_rung3: no lock acquired or no barrier waited")
        if eng.steps_run != MP_DEPTH:
            fail(f"multiprog_rung3: stopped at step {eng.steps_run}, not {MP_DEPTH}")
        if len(samples) != n_chunks or len(spans) != n_chunks:
            fail(f"multiprog_rung3: {len(samples)} samples and {len(spans)} chunk spans "
                 f"for {n_chunks} chunks")
        if sum(x["deltas"]["instructions"] for x in samples) != got["instructions"]:
            fail("multiprog_rung3: the recorder's instruction deltas miss the total")
        eng.verify_invariants()
        # the CLI below finishes the run from this state
        mp_ck = os.path.join(mp_dir, "ck")
        os.makedirs(mp_ck)
        eng.save_checkpoint(os.path.join(mp_ck, "ckpt-00000001.npz"))
        del eng
        torch.cuda.empty_cache()

        # the same programs through `python -m primesim_tpu_torch run`,
        # resumed from the snapshot at MP_DEPTH and run to the end: its
        # summary is the whole run's
        out = {k: os.path.join(mp_dir, f) for k, f in (
            ("metrics", "m.jsonl"), ("trace", "t.json"), ("report", "r.txt"))}
        cmd = [sys.executable, "-m", "primesim_tpu_torch", "run", mpfx["config"],
               *[a for p in mp_paths for a in ("--trace", p)], "--fold",
               "--chunk-steps", str(mpfx["chunk_steps"]), "--obs", "full",
               "--metrics-out", out["metrics"], "--trace-out", out["trace"],
               "--report", out["report"], "--per-core-limit", "16",
               "--checkpoint-dir", mp_ck, "--resume"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"cli_multiprog: exited {r.returncode}: {r.stderr[-500:]}")
        detail = json.loads(r.stdout.strip().splitlines()[-1])["detail"]
        with open(out["metrics"]) as f:
            lines = [json.loads(ln) for ln in f]
        with open(out["trace"]) as f:
            n_events = len(json.load(f)["traceEvents"])
        with open(out["report"]) as f:
            has_timeline = "TIMELINE" in f.read()
        want = {"instructions": mpfx["digest"]["instructions"],
                "max_core_cycles": mpfx["digest"]["max_core_cycles"],
                "noc_msgs": mpfx["digest"]["counter_sums"]["noc_msgs"]}
        split = {k: float(np.mean([x["phases"][k] for x in lines]))
                 for k in ("dispatch", "drain", "rebase")}
        emit({"phase": "cli_multiprog", "summary": {k: detail[k] for k in want},
              "resumed_from": os.path.basename(detail.get("resumed_from") or ""),
              "steps": detail["steps"], "wall_s": detail["wall_s"], "command_s": cli_s,
              "timeline": detail.get("timeline"), "metrics_lines": len(lines),
              "trace_events": n_events, "report_has_timeline": has_timeline,
              "mean_phase_s_per_chunk": split,
              "chunk_wall_s": [x["wall_s"] for x in lines], "gpu": smi_line})
        if {k: detail[k] for k in want} != want:
            fail(f"cli_multiprog: summary {detail} != the JAX digest's {want}")
        if len(lines) != (detail["steps"] - MP_DEPTH) // mpfx["chunk_steps"] \
                or not has_timeline or detail["steps"] != mpfx["digest"]["steps"]:
            fail(f"cli_multiprog: {len(lines)} metrics lines for {detail['steps']} steps "
                 f"from {MP_DEPTH}, TIMELINE {has_timeline}")
    finally:
        shutil.rmtree(mp_dir, ignore_errors=True)

    # ---- 9. the fleet (FleetEngine): B elements of one geometry through
    # one set of launches a step. fleet_headline: the headline machine,
    # B = 8 with its own overrides per element, one element on a shorter
    # trace that freezes early; fleet_rung3: rung 3, B = 4, checkpointed
    # at FLEET_CUT and resumed in a fresh fleet. Each element's digest
    # against the committed JAX one, element 0 against the solo path's.
    made = {json.dumps(hfx["trace"], sort_keys=True): trace}  # the headline trace, made once

    def fleet_fixture(name):
        return load_fleet_fixture(name, made)

    def stage_batched(names, step, store):
        """Wrap the kernels `names` so that the `step`-th call of each
        keeps clones of its (batched) arguments in `store`; returns the
        undo."""
        for k in names:
            real, calls = wrappers[k], [0]

            def rec(*args, _k=k, _real=real, _calls=calls, **kw):
                if _calls[0] == step:
                    a = args[1:] if _k in STEP_KERNELS else args
                    store[_k] = ([x.clone() if torch.is_tensor(x) else x for x in a], kw)
                _calls[0] += 1
                return _real(*args, **kw)
            setattr(mods[k], k, rec)
        return lambda: [setattr(mods[k], k, wrappers[k]) for k in names]

    fleet_staged, fleet_launches, fleet_lines = {}, {}, {}
    for path, fname, solo_fx, ran, cut in (
            ("fleet_headline", "fleet_headline", hfx, STEP_KERNELS, None),
            ("fleet_rung3", "fleet_rung3", r3fx, tuple(wrappers), FLEET_CUT)):
        ffx, fcfg, ftrs, fovs = fleet_fixture(fname)
        if cut is not None:  # a shallower run, held to the JAX digests at its depth
            ffx = {**ffx, "elements": [{**e, "digest": d} for e, d in zip(
                ffx["elements"], load_cut("fleet_rung3_cut", FLEET_DEPTH)["digests"])]}
        ck = os.path.join(tempfile.gettempdir(), f"chip_smoke_{os.getpid()}_{path}.npz")
        held = torch.cuda.memory_allocated()
        fl = FleetEngine(fcfg, ftrs, fovs, chunk_steps=ffx["chunk_steps"], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ck_info = {}
        t0 = time.perf_counter()
        try:
            if cut is None:
                fl.run()
            else:
                fl.run_steps(cut)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fl.save_checkpoint(ck)
                t2 = time.perf_counter()
                del fl
                torch.cuda.empty_cache()
                fl = FleetEngine(fcfg, ftrs, fovs, chunk_steps=ffx["chunk_steps"], device=dev)
                fl.load_checkpoint(ck)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                if list(fl.steps_run) != [cut] * fl.n_elements:
                    fail(f"{path}: resumed at steps {list(fl.steps_run)}, not {cut}")
                ck_info = {"checkpoint_step": cut, "checkpoint_bytes": os.path.getsize(ck),
                           "save_s": t2 - t1, "load_s": t3 - t2, "depth": FLEET_DEPTH}
                fl.run_steps(FLEET_DEPTH - cut)
            torch.cuda.synchronize()
        finally:
            if os.path.exists(ck):
                os.unlink(ck)
        wall = time.perf_counter() - t0 - ck_info.get("save_s", 0) - ck_info.get("load_s", 0)
        fleet_launches[path] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
        steps = int(fl.steps_run.max())
        cnt, cyc = fl.counters, fl.cycles
        got = [run_digest(fl.steps_run[i], cyc[i], {k: v[i] for k, v in cnt.items()},
                          fl.state.link_free[i].cpu().numpy(), fl.state.dram_free[i].cpu().numpy())
               for i in range(fl.n_elements)]
        ins = sum(g["instructions"] for g in got)
        same = [g == e["digest"] for g, e in zip(got, ffx["elements"])]
        fleet_lines[path] = {
            "phase": path, "B": fl.n_elements, "steps": steps,
            "steps_by_element": fl.steps_run.tolist(), "wall_s": wall,
            "aggregate_mips": ins / wall / 1e6, "instructions": ins,
            "launches": fleet_launches[path],
            "launches_per_step": {k: n / steps for k, n in fleet_launches[path].items()},
            "peak_memory_bytes": peak, **ck_info,
            "max_core_cycles": [g["max_core_cycles"] for g in got],
            "equals_jax_digest": same,
            "element0_equals_solo": got[0] == solo_fx["digest"] if cut is None else None,
            "gpu": smi_line}
        emit(fleet_lines[path])
        del fl
        torch.cuda.empty_cache()
        for k, n in fleet_launches[path].items():
            if n != (steps if k in ran else 0):
                fail(f"{path}: {k} launched {n} times in {steps} fleet steps")
        for i, (g, e) in enumerate(zip(got, ffx["elements"])):
            for k, want in e["digest"].items():
                if g[k] != want:
                    fail(f"{path}: element {i} {k} {g[k]} != the JAX package's {want}")
        if cut is None and got[0] != solo_fx["digest"]:
            fail(f"{path}: element 0 differs from the solo path's digest")
        if path == "fleet_headline" and not max(fl_s := [g["steps"] for g in got]) > fl_s[-1]:
            fail(f"{path}: the short element finished with the others ({fl_s})")

    # ---- cli_sweep: `sweep` on rung 1 with three --vary sets, one a
    # duplicate, on the card and on the CPU side by side: the same lines
    # but for wall seconds and MIPS, the same dedup warning
    res = sweep_runs  # run beside cli_faults and cli_xml

    def sweep_lines(out):
        lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        for ln in lines:
            if ln.get("unit") == "MIPS":
                ln.pop("value")
            ln["detail"].pop("wall_s", None)
        return lines

    swl = {d: sweep_lines(r[1]) for d, r in res.items()}
    warn = {d: [ln for ln in r[2].splitlines() if "WARNING" in ln] for d, r in res.items()}
    emit({"phase": "cli_sweep", "returncodes": {d: r[0] for d, r in res.items()},
          "lines": len(swl["cuda"]), "card_equals_cpu": swl["cuda"] == swl["cpu"],
          "dedup_warning": warn["cuda"],
          "max_core_cycles": [ln["detail"].get("max_core_cycles") for ln in swl["cuda"]]})
    if any(r[0] != 0 for r in res.values()):
        fail(f"cli_sweep: exit codes {[r[0] for r in res.values()]}: {res['cuda'][2][-500:]}")
    if swl["cuda"] != swl["cpu"] or len(swl["cuda"]) != 4 or warn["cuda"] != warn["cpu"] \
            or not warn["cuda"]:
        fail(f"cli_sweep: card {swl['cuda']} != CPU {swl['cpu']} (warnings {warn})")

    # ---- 10. the supervised and forked paths, before any profiler session
    # (the main paths' timing and theirs are comparable)
    fleet_launches.update(resilience_phases(
        dev, smi_line, (hffx, cfg_hf, trace_hf), made, baselines["headline_faults"]))

    # ---- 11. the streamed and captured paths, before any profiler session
    fleet_launches.update(stream_phases(
        dev, smi_line, (hfx, cfg, trace), large["rung5"], baselines))

    # ---- 12. the attested and served paths, before any profiler session
    fleet_launches.update(attest_serve_phases(dev, smi_line, (hfx, cfg, trace), baselines, made))

    fleet_launches.update(pool_launches)  # the pooled (13), calibrate and chaos (14) paths
    fleet_launches.update(shard_launches)  # the sharded paths (16)
    fleet_launches["serve_recover"] = recover_launches

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
            key = (x.untyped_storage().data_ptr(), x.storage_offset(), x.shape)
            if key not in memo:  # the views of one batch of one share a key
                memo[key] = (x, x.clone())  # the original keeps its storage
            return memo[key][1]

        def recorder(name):
            real = wrappers[name]

            def rec(mcfg, *args, **kw):
                a = solo_args(name, args)
                if name == "probe_classify":
                    cur.update(step=cur["step"] + 1, probe=(a, kw), take=False)
                elif name == "sharer_reductions":
                    rows = int((a[4] | a[5]).sum())  # a sync: staging only
                    if rows > best["rows"]:
                        memo = {}
                        best.clear()
                        best.update(rows=rows, step=cur["step"], memo=memo, got={
                            k: ([grab(memo, x) for x in a_], kw_)
                            for k, (a_, kw_) in (("probe_classify", cur["probe"]),
                                                 (name, (a, kw)))})
                        cur["take"] = True
                elif cur["take"]:  # commit_step of the step just kept
                    best["got"][name] = ([grab(best["memo"], x) for x in a], kw)
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

    kernel_us, modes, mode_cfg = {}, {}, {}

    def mode_line(path, pcfg, staged, n_launch):
        """The step kernels alone on a path's staged step: held to their
        plain versions, timed by events, bounded; one "mode" line."""
        staged_step, mode_in = staged
        modes[path], mode_cfg[path] = {}, pcfg
        for k in STEP_KERNELS:
            args, kw = mode_in[k]
            compare(k, args, kw, mcfg=pcfg)
            bnd, info, nb = bound_of(k, args, kw, pcfg)
            modes[path][k] = {
                **time_alone(k, args, kw, pcfg),
                "profiler_us_in_step": kernel_us.get(path, {}).get(k),
                "launches": n_launch[k], "bound_ms": bnd[0], "bound_by": bnd[1],
                "bytes": nb, "detail": info,
            }
        del mode_in, staged
        torch.cuda.empty_cache()
        emit({"phase": "mode", "path": path, "staged_step": staged_step,
              "kernels": modes[path], "max_abs_err": max_err,
              "event_floor_ms": event_floor_ms, "gpu": smi_line})

    def sync_free_window():
        """64 faulted headline steps from step 256 (the scheduled kill of
        core 13 and its scrub first) through run_chunk under CUDA's sync
        debug mode: the synchronising calls they make, and the scrubs."""
        eng = Engine(cfg_hf, trace_hf, chunk_steps=64, device=dev)
        eng.run_steps(256)
        scrub_at = eng.scrub_offsets()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_chunk(cfg_hf, 64, eng.events, eng.state, eng.has_sync, scrub_at=scrub_at)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        del eng
        torch.cuda.empty_cache()
        # the sync debug mode's own notice that it is a prototype is no sync
        return ([str(w.message)[:200] for w in caught if "synchroniz" in str(w.message)
                 and "prototype feature" not in str(w.message)], sorted(scrub_at))

    def stage_busiest_arrivals(pcfg, ptrace):
        """Run up to MP_STAGE_STEPS steps of a sync path and keep
        router_cascade's inputs at the step whose barrier-arrival leg has
        the most live hops (each argument cloned when a step beats the
        best so far: the link clocks it updates in place are its inputs).
        Returns (step, args, kw)."""
        eng = Engine(pcfg, ptrace, chunk_steps=64, device=dev)
        best, calls = {"hops": 0}, [0]
        real = wrappers["router_cascade"]

        def rec(*args, **kw):
            if kw.get("has_sync"):
                a = solo_args("router_cascade", args)
                ok = a[3]
                live = int(ok.reshape(ok.shape[0], 3, -1)[:, 2].sum())  # a sync: staging only
                if live > best["hops"]:
                    best.update(hops=live, step=calls[0], args=[
                        x.clone() if torch.is_tensor(x) else x for x in a], kw=dict(kw))
            calls[0] += 1
            return real(*args, **kw)

        router_kernels.router_cascade = rec
        try:
            while eng.steps_run < MP_STAGE_STEPS and not eng.done():
                eng.run_steps(64)
        finally:
            router_kernels.router_cascade = real
        del eng
        torch.cuda.empty_cache()
        if not best["hops"]:
            fail(f"stage: no barrier arrival in {MP_STAGE_STEPS} steps")
        return best["step"], best["args"], best["kw"]

    def cascade_mode_line(path, pcfg, ptrace, n_launch):
        """router_cascade's three legs on the path's busiest arrival step:
        held to the plain version, timed by events, bounded; a "mode"
        line."""
        step_no, args, kw = stage_busiest_arrivals(pcfg, ptrace)
        compare("router_cascade", args, kw)
        bnd, info, nb = cascade_bound(args, kw)
        modes[path], mode_cfg[path] = {"router_cascade": {
            **time_alone("router_cascade", args, kw),
            "profiler_us_in_step": kernel_us.get(path, {}).get("router_cascade"),
            "launches": n_launch["router_cascade"], "bound_ms": bnd[0], "bound_by": bnd[1],
            "bytes": nb, "detail": info}}, pcfg
        del args
        torch.cuda.empty_cache()
        emit({"phase": "mode", "path": path, "staged_step": step_no,
              "kernels": modes[path], "max_abs_err": max_err,
              "event_floor_ms": event_floor_ms, "gpu": smi_line})

    by_path = {p: (pc, pt, r) for p, pc, _, pt, r in main_paths}
    by_path["multiprog_rung3"] = (cfg_mp, trace_mp, tuple(wrappers))
    for path in ("headline", "rung3", *MODE_PATHS, "headline_faults", "multiprog_rung3"):
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
        if mode_in is not None:
            mode_line(path, pcfg, mode_in, launches[path])
        if path == "multiprog_rung3":
            cascade_mode_line(path, pcfg, ptrace, launches[path])

    # the faulted step makes no host synchronisation, its scrub included
    syncs, scrub_at = sync_free_window()
    emit({"phase": "sync_check", "path": "headline_faults", "steps": [256, 319],
          "scrub_offsets": scrub_at, "synchronising_calls": syncs})
    if syncs or 0 not in scrub_at:
        fail(f"sync_check: {len(syncs)} synchronising calls ({syncs[:3]}), "
             f"scrub offsets {scrub_at}")

    # one recorded chunk of the multiprogrammed path (locks, barriers, the
    # three-leg cascade) makes exactly one synchronising call: its transfer
    eng = Engine(cfg_mp, trace_mp, chunk_steps=64, device=dev)
    eng.run_steps(256)
    Recorder("full").attach(eng)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng._chunk()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message)[:200] for w in caught if "synchroniz" in str(w.message)
             and "prototype feature" not in str(w.message)]
    chunks = len(eng.obs.store)
    del eng
    torch.cuda.empty_cache()
    emit({"phase": "sync_check", "path": "multiprog_rung3", "steps": [256, 319],
          "recorder": "full", "recorded_chunks": chunks, "synchronising_calls": syncs})
    if len(syncs) != 1 or chunks != 1:
        fail(f"sync_check: a recorded chunk made {len(syncs)} synchronising calls ({syncs[:3]})")

    # one attested chunk of the headline makes at most two synchronising
    # calls: the chunk's transfer and the chain's one batched transfer of
    # the state's leaves
    from primesim_tpu_torch.attest import SoloAttest

    eng = Engine(cfg, trace, chunk_steps=64, device=dev)
    eng.attest = SoloAttest(64)
    eng.run_steps(64)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng._chunk()
            eng.attest.observe(eng)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message)[:200] for w in caught if "synchroniz" in str(w.message)
             and "prototype feature" not in str(w.message)]
    emit({"phase": "sync_check", "path": "attest_headline", "steps": [64, 127],
          "attest_chunks": eng.attest.payload()["chunks"], "bytes_hashed": eng.attest.stats["bytes"],
          "synchronising_calls": syncs})
    del eng
    torch.cuda.empty_cache()
    if len(syncs) > 2:
        fail(f"sync_check: an attested chunk made {len(syncs)} synchronising calls ({syncs[:3]})")

    # the ring mode of sharer_reductions on the reduced ring machines, at
    # the busiest step (by active rows) of a 64-step chunk
    for path, start in RING_MODES:
        mcfg, rtr, n_launch = reduced_runs[path]
        eng = Engine(mcfg, rtr, chunk_steps=64, device=dev)
        eng.run_steps(start)
        staged = stage_busiest_step(eng)
        del eng
        mode_line(path, mcfg, staged, n_launch)

    # ---- fleet_scaling: the headline fleet's first B elements, B = 1, 4
    # and 8, from step 0 for FLEET_SCALE_STEPS steps in chunks of 64
    # (aggregate MIPS over that wall), then a profiled 64-step window
    # (device events and busy time a step); and a window of the rung-3
    # fleet (B = 4) from step 256. Recorded, not gated. The step after each
    # window (B = 8; rung 3) stages the batched kernels' inputs, and each
    # kernel is timed alone on them (fleet_kernels).
    ffx, fcfg, ftrs, fovs = fleet_fixture("fleet_headline")
    scaling = {}

    def fleet_window(fl, n_steps=64):
        dev_ev, window_s, top_ops = device_events(lambda: fl.run_steps(n_steps))
        busy_us, end = 0.0, None
        for a0, b0, _ in dev_ev:  # union of device intervals
            if end is None or a0 > end:
                busy_us += b0 - a0
                end = b0
            elif b0 > end:
                busy_us += b0 - end
                end = b0
        return {"window_steps": n_steps, "window_s": window_s,
                "device_events_per_step": len(dev_ev) / n_steps,
                "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
                "device_busy_share_of_window": busy_us * 1e-6 / window_s if dev_ev else None}

    for B in (1, 4, 8):
        fl = FleetEngine(fcfg, ftrs[:B], fovs[:B], chunk_steps=64, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        fl.run_steps(FLEET_SCALE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ins = int(fl.counters["instructions"].sum())
        scaling[B] = {"steps": FLEET_SCALE_STEPS, "wall_s": wall,
                      "aggregate_mips": ins / wall / 1e6, "instructions": ins,
                      "launches_per_step": {k: n / FLEET_SCALE_STEPS
                                            for k, n in build.LAUNCHES.items()},
                      **fleet_window(fl)}
        if B == 8:  # the step after the window: the batched step kernels' inputs
            undo = stage_batched(STEP_KERNELS, 0, fleet_staged)
            try:
                fl.run_steps(64)
            finally:
                undo()
        del fl
        torch.cuda.empty_cache()
    # the serving fleets' sync path (force_sync, as make_slots builds
    # them): the same B = 1 element with phase 2.7 on, its device events a
    # step beside the plain fleet's
    fl = FleetEngine(fcfg, ftrs[:1], fovs[:1], chunk_steps=64, device=dev, force_sync=True)
    sync_path = fleet_window(fl)  # steps 0-63: a headline step's launches do not vary
    sync_path["extra_device_events_per_step"] = (
        sync_path["device_events_per_step"] - scaling[1]["device_events_per_step"])
    del fl
    torch.cuda.empty_cache()
    emit({"phase": "fleet_scaling", "path": "fleet_headline", "by_B": scaling,
          "sync_path_B1": sync_path, "gpu": smi_line})
    ffx, fcfg, ftrs, fovs = fleet_fixture("fleet_rung3")
    fl = FleetEngine(fcfg, ftrs, fovs, chunk_steps=64, device=dev)
    fl.run_steps(256)
    torch.cuda.synchronize()
    emit({"phase": "fleet_profile", "path": "fleet_rung3", "B": fl.n_elements,
          "steps": [256, 319], **fleet_window(fl), "gpu": smi_line})
    undo = stage_batched(("router_cascade",), 0, fleet_staged)  # step 320
    try:
        fl.run_steps(64)
    finally:
        undo()
    del fl
    torch.cuda.empty_cache()
    if set(fleet_staged) != set(wrappers):
        fail(f"fleet: staged inputs of {sorted(fleet_staged)} only")

    # each batched kernel alone on the staged step's inputs (a fleet of B)
    fleet_timing = {}
    for k in wrappers:
        args, kw = fleet_staged[k]
        fcfg = cfg3 if k == "router_cascade" else cfg
        compare(k, args, kw, mcfg=fcfg, errs=max_err_b)
        if k == "router_cascade":
            bnd, info, nb = cascade_bound(args, kw)
        else:
            bnd, info, nb = bound_of(k, args, kw, fcfg)
        fpath = "fleet_rung3" if k == "router_cascade" else "fleet_headline"
        fleet_timing[k] = {"B": fleet_lines[fpath]["B"], "path": fpath,
                           "staged_step": FLEET_STAGE[fpath], "chunk_steps": 64,
                           "launches": fleet_launches[fpath][k],
                           **time_alone(k, args, kw, fcfg),
                           "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": nb,
                           "max_abs_err": max_err_b[k]}
    del fleet_staged
    torch.cuda.empty_cache()
    emit({"phase": "fleet_kernels", "kernels": fleet_timing,
          "event_floor_ms": event_floor_ms, "gpu": smi_line})

    # ---- the supervised and forked paths

    print(json.dumps({"phase_times": PHASE_TIMES}), flush=True)
    machine_of = {p: {"topology": c.noc.topology, "coherence": c.coherence,
                      "sharer_group": c.sharer_group, "sharer_words": c.n_sharer_words}
                  for p, c in mode_cfg.items()}
    shard_machine = {**machine_of.get("headline", {"topology": cfg.noc.topology,
                                                   "coherence": cfg.coherence,
                                                   "sharer_group": cfg.sharer_group,
                                                   "sharer_words": cfg.n_sharer_words}),
                     "shards": SHARDS}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1],
         "launches": launches["rung3" if k in RUNG3_STAGED else "headline"][k],
         "launches_by_path": {**{p: launches[p][k] for p in launches},
                              **{p: fleet_launches[p][k] for p in fleet_launches}},
         "max_abs_err": max_err[k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"],
         "profiler_us_per_launch": timing[k]["profiler_us"],
         "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": None,
         "kernel_modes": KERNEL_MODES[k],
         "batched": fleet_timing[k],
         "modes": {**{p: {"machine": machine_of[p],
                          **{f: m[k][f] for f in ("launches", "ms", "plain_ms",
                                                  "profiler_us_in_step", "bound_ms",
                                                  "bound_by")}}
                      for p, m in modes.items() if k in m},
                   **({"sharded_headline": {"machine": shard_machine, **{
                       f: shard_mode[k][f] for f in ("mode", "launches", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "max_abs_err")}}}
                      if k in shard_mode else {})}}
        for k in wrappers
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[2]) if sys.argv[1:2] == ["--child"] else main())
