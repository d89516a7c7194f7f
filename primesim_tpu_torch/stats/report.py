"""End-of-run text report (SURVEY.md §2 #12, §5.5).

The reference writes a text report at fini with per-core and aggregate
stats (per-core ins/cycles/IPC, cache hit/miss per level, network traffic,
simulated time, host wall time, MIPS). This module renders the same
content from the canonical counter dict + per-core cycle array; the CLI
(`primesim_tpu.cli run --report`) uses it.
"""

from __future__ import annotations

import numpy as np

from ..config.machine import MachineConfig


def _rate(hits, total) -> str:
    t = int(total)
    return f"{int(hits) / t:7.2%}" if t else "    n/a"


def render_report(
    cfg: MachineConfig,
    counters: dict[str, np.ndarray],
    cycles: np.ndarray,
    wall_s: float | None = None,
    per_core_limit: int = 64,
    title: str = "primesim_tpu simulation report",
    resilience: list[str] | None = None,
    service: dict | None = None,
    timeline: dict | None = None,
    pool: dict | None = None,
) -> str:
    """Render the reference-style text report.

    `counters` is the canonical per-core counter dict (stats.counters),
    `cycles` the per-core final clocks; `wall_s` (host wall time) enables
    the MIPS line. Per-core rows are capped at `per_core_limit` (0 = all).
    `resilience` (RunSupervisor.log_lines()) appends a RESILIENCE section
    recording every checkpoint/retry/degradation decision of a supervised
    run — the audit trail the failure-model contract (DESIGN.md §10)
    promises. `service` (serve Scheduler.service_report()) appends a
    SERVICE section: jobs by terminal state, aggregate MIPS over the
    serving window, and accept-to-terminal latency percentiles.
    `timeline` (obs.MetricStore.summary(), present only when `--obs` is
    on) appends a TIMELINE section: per-chunk throughput extremes and
    the slowest chunk's index in the run.
    `pool` (PoolCoordinator.pool_report()) appends a POOL section: unit
    outcomes and the lease protocol's decisions — redispatches, expired
    leases, hedges, duplicate acks — for an elastic `sweep --workers`
    campaign.
    """
    C = cfg.n_cores
    ins = counters["instructions"].astype(np.int64)
    cyc = np.asarray(cycles, dtype=np.int64)
    tot_ins = int(ins.sum())
    max_cyc = int(cyc.max()) if C else 0

    l1_reads = counters["l1_read_hits"] + counters["l1_read_misses"]
    l1_writes = counters["l1_write_hits"] + counters["l1_write_misses"] + counters["upgrades"]
    llc_acc = counters["llc_hits"] + counters["llc_misses"]

    lines: list[str] = []
    add = lines.append
    add("=" * 72)
    add(title)
    add("=" * 72)
    add(
        f"machine: {C} cores, {cfg.n_banks} LLC banks, "
        f"{cfg.noc.mesh_x}x{cfg.noc.mesh_y} mesh, quantum {cfg.quantum}"
    )
    add(
        f"l1: {cfg.l1.size}B {cfg.l1.ways}w lat {cfg.l1.latency} | "
        f"llc/bank: {cfg.llc.size}B {cfg.llc.ways}w lat {cfg.llc.latency} | "
        f"dram {cfg.dram_lat} | line {cfg.l1.line}B"
    )
    add("")
    add("AGGREGATE")
    add(f"  instructions        {tot_ins:>16,}")
    add(f"  max core cycles     {max_cyc:>16,}")
    ipc = tot_ins / (max_cyc * C) if max_cyc and C else 0.0
    add(f"  IPC (agg/core/cyc)  {ipc:>16.4f}")
    if wall_s is not None and wall_s > 0:
        add(f"  host wall seconds   {wall_s:>16.2f}")
        add(f"  simulated MIPS      {tot_ins / wall_s / 1e6:>16.3f}")
        add(f"  sim cycles/sec      {max_cyc / wall_s:>16,.0f}")
    add(f"  L1 read hit rate    {_rate(counters['l1_read_hits'].sum(), l1_reads.sum()):>16}")
    add(f"  L1 write hit rate   {_rate(counters['l1_write_hits'].sum(), l1_writes.sum()):>16}")
    add(f"  LLC hit rate        {_rate(counters['llc_hits'].sum(), llc_acc.sum()):>16}")
    add(f"  DRAM accesses       {int(counters['dram_accesses'].sum()):>16,}")
    add(f"  L1 writebacks       {int(counters['l1_writebacks'].sum()):>16,}")
    add(f"  LLC writebacks      {int(counters['llc_writebacks'].sum()):>16,}")
    add(f"  probes              {int(counters['probes'].sum()):>16,}")
    add(f"  invalidations       {int(counters['invalidations'].sum()):>16,}")
    add(f"  NoC messages        {int(counters['noc_msgs'].sum()):>16,}")
    add(f"  NoC hops            {int(counters['noc_hops'].sum()):>16,}")
    add(f"  arbitration retries {int(counters['retries'].sum()):>16,}")
    add(f"  NoC contention cyc  {int(counters['noc_contention_cycles'].sum()):>16,}")
    add(f"  DRAM queue cycles   {int(counters['dram_queue_cycles'].sum()):>16,}")
    locks = int(counters["lock_acquires"].sum())
    if locks or int(counters["barrier_waits"].sum()):
        add(f"  lock acquires       {locks:>16,}")
        add(f"  lock spins          {int(counters['lock_spins'].sum()):>16,}")
        add(f"  barrier waits       {int(counters['barrier_waits'].sum()):>16,}")
    add("")
    n_show = C if per_core_limit == 0 else min(C, per_core_limit)
    add(f"PER-CORE (first {n_show} of {C})")
    add(
        "  core      instructions          cycles     IPC   l1r_hit  l1w_hit"
        "   llc_hit"
    )
    for c in range(n_show):
        cipc = ins[c] / cyc[c] if cyc[c] else 0.0
        add(
            f"  {c:>4}  {int(ins[c]):>16,}  {int(cyc[c]):>14,}  {cipc:6.3f}"
            f"  {_rate(counters['l1_read_hits'][c], l1_reads[c])}"
            f"  {_rate(counters['l1_write_hits'][c], l1_writes[c])}"
            f"  {_rate(counters['llc_hits'][c], llc_acc[c])}"
        )
    fault_keys = ("core_failstops", "noc_reroutes", "ecc_corrected", "ecc_due")
    fault_total = sum(int(counters[k].sum()) for k in fault_keys if k in counters)
    if getattr(cfg, "faults_enabled", False) or fault_total:
        # only rendered when fault injection is configured (or somehow
        # counted): the faults-off report stays byte-identical to goldens
        add("")
        add("FAULTS")
        add(f"  core fail-stops     {int(counters['core_failstops'].sum()):>16,}")
        add(f"  NoC reroutes        {int(counters['noc_reroutes'].sum()):>16,}")
        add(f"  ECC corrected       {int(counters['ecc_corrected'].sum()):>16,}")
        add(f"  ECC DUE             {int(counters['ecc_due'].sum()):>16,}")
        dead = np.flatnonzero(counters["core_failstops"])
        if dead.size:
            add(f"  dead cores          {', '.join(map(str, dead.tolist()))}")
    if timeline:
        add("")
        add("TIMELINE")
        add(f"  chunks committed    {int(timeline.get('chunks', 0)):>16,}")
        if timeline.get("dropped"):
            add(f"  samples dropped     {int(timeline['dropped']):>16,}")
        add(f"  peak chunk MIPS     {float(timeline.get('peak_chunk_mips', 0.0)):>16.3f}")
        add(f"  mean chunk MIPS     {float(timeline.get('mean_chunk_mips', 0.0)):>16.3f}")
        if timeline.get("slowest_chunk_seq", -1) >= 0:
            add(
                f"  slowest chunk       {int(timeline['slowest_chunk_seq']):>16,}"
                f"  ({float(timeline.get('slowest_chunk_wall_s', 0.0)) * 1e3:.1f} ms)"
            )
        labels = timeline.get("labels") or {}
        if "prefix" in labels:
            # a prefix-forked campaign: show where the wall went so the
            # shared-prefix win (or a cache hit's absent prefix) is visible
            pre = labels["prefix"]
            tail_wall = sum(
                v.get("wall_s", 0.0) for k, v in labels.items() if k != "prefix"
            )
            add(f"  prefix wall seconds {float(pre.get('wall_s', 0.0)):>16.2f}")
            add(f"  tail wall seconds   {tail_wall:>16.2f}")
    if resilience:
        add("")
        add("RESILIENCE")
        for line in resilience:
            add(f"  {line}")
    if service:
        add("")
        add("SERVICE")
        add(f"  jobs completed      {int(service.get('jobs_completed', 0)):>16,}")
        for state, n in sorted(service.get("jobs_by_state", {}).items()):
            add(f"  {state.lower():<19} {int(n):>16,}")
        add(f"  aggregate MIPS      {float(service.get('aggregate_mips', 0.0)):>16.3f}")
        lat = service.get("latency_s") or {}
        for p in ("p50", "p90", "p99"):
            if lat.get(p) is not None:
                add(f"  latency {p}         {lat[p]:>16.3f}s")
        if service.get("uptime_s") is not None:
            add(f"  uptime seconds      {float(service['uptime_s']):>16.1f}")
    if pool:
        add("")
        add("POOL")
        add(f"  units total         {int(pool.get('units_total', 0)):>16,}")
        add(f"  units done          {int(pool.get('units_done', 0)):>16,}")
        add(f"  units poisoned      {int(pool.get('units_poisoned', 0)):>16,}")
        add(f"  workers seen        {int(pool.get('workers_seen', 0)):>16,}")
        add(f"  expired leases      {int(pool.get('expired_leases', 0)):>16,}")
        add(f"  redispatches        {int(pool.get('redispatches', 0)):>16,}")
        add(f"  hedges              {int(pool.get('hedges', 0)):>16,}")
        add(f"  duplicate acks      {int(pool.get('duplicate_acks', 0)):>16,}")
        add(f"  heartbeats          {int(pool.get('heartbeats', 0)):>16,}")
    add("=" * 72)
    return "\n".join(lines) + "\n"


def write_report(path: str, *args, **kw) -> None:
    with open(path, "w") as f:
        f.write(render_report(*args, **kw))
