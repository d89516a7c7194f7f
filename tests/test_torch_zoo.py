"""The port's machine zoo (DESIGN.md §25: torus and ring NoCs, MOESI's
derived Owned state, the stride prefetcher) against the JAX package, on
the CPU.

Kernel: the plain `commit_step` in its MOESI mode against the JAX Pallas
kernel in interpret mode, on random inputs whose GETS-probe rows hold
sharer words with bit 31. Whole runs: tests/test_zoo.py's five
`ZOO_COMBOS` machines (8 cores, chunk_steps 32) through the port's
`Engine(device="cpu")`, each held to one run of the JAX engine with the
XLA step, one with the Pallas step and one of the golden model (shared
by a module-scoped fixture): cycles, all 26 counters and every state
field. Then MOESI's owner retention and its divergence from MESI, the
prefetcher's coverage on ascending and descending streams, the coarse
vector and the link and router contention models on the torus and the
ring, MOESI's weaker directory invariant, and a JAX state with live
prefetcher arrays resumed in the port.
Integer simulator: every tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import NocConfig, small_test_config
from primesim_tpu.sim.engine import Engine as JEngine
from primesim_tpu.sim.engine import run_chunk as j_run_chunk
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import EV_INS, EV_LD, from_event_lists
from primesim_tpu_torch import convert
from primesim_tpu_torch.kernels.step_kernels import (
    CL_GETS_PROBE,
    CL_GETS_SHARED,
    CL_JOIN,
    CL_LLC_HIT,
    CL_LLC_HWAY,
    CL_OCLAMP,
    CL_SLOT,
    CL_TAKES_OWN,
    CL_WINNER,
)
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim.state import M, llc_meta_width
from primesim_tpu_torch.sim.validate import (
    check_invariants,
    l1_views,
    llc_views,
    sharers_view,
)

from test_torch_engine import (
    assert_engines_equal,
    assert_golden_equal,
    assert_port_matches_everything,
    assert_states_equal,
    jax_arrays,
    port_cfg,
    port_trace,
)
from test_torch_kernels import _assert_same, _cfgs, _commit_both, _commit_inputs, _restage
from test_zoo import ZOO_COMBOS, _two_core_sharing_trace, _zoo_trace, zoo_cfg

def run_port(cfg, trace, chunk_steps=32):
    te = t_engine.Engine(port_cfg(cfg), port_trace(trace), chunk_steps, device="cpu")
    te.run()
    te.verify_invariants()
    return te


def run_jax(cfg, trace, chunk_steps=32, impl="xla"):
    je = JEngine(dataclasses.replace(cfg, step_impl=impl), trace, chunk_steps)
    je.run()
    return je


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("rl", [0, 2])
def test_commit_step_moesi_matches_pallas(C, rl):
    """GETS-probe winners keep the probed owner and OR the requester and
    the owner into rows whose sharer words already hold bits, bit 31
    among them; other winners, the joiners and the MESI transitions in
    the same call."""
    jcfg, _ = _cfgs(C)
    jcfg = dataclasses.replace(jcfg, coherence="moesi")
    tcfg = port_cfg(jcfg)
    arrs = _commit_inputs(jcfg, 500 + C + rl, rl)
    lanes, dirm = arrs[5], arrs[1]
    probe = np.arange(C) % 3 == 0
    lanes[probe, CL_WINNER] = lanes[probe, CL_LLC_HIT] = lanes[probe, CL_GETS_PROBE] = 1
    lanes[probe, CL_JOIN] = lanes[probe, CL_TAKES_OWN] = lanes[probe, CL_GETS_SHARED] = 0
    # one winner per row: the probe rows are each core's own
    lanes[probe, CL_SLOT] = np.nonzero(probe)[0] % len(dirm)
    lanes[~probe, CL_SLOT] = len(dirm) - 1 - np.arange((~probe).sum()) % (len(dirm) // 2)
    arrs = _restage(jcfg, arrs)
    shw = arrs[3]
    assert (shw[probe] != 0).any(1).all() and (shw[probe] < 0).any()  # bit 31 held
    j_out, t_out = _commit_both(jcfg, tcfg, arrs)
    _assert_same(j_out, t_out, ["l1", "dirm", "counters"])
    # MOESI, not MESI: the probed owner stays and the old bits remain
    new = t_out[1].numpy()
    hway = lanes[:, CL_LLC_HWAY]
    NW, MW = jcfg.n_sharer_words, llc_meta_width(jcfg)
    for c in np.nonzero(probe)[0]:
        row = new[lanes[c, CL_SLOT]]
        assert row[2 * hway[c] + 1] == lanes[c, CL_OCLAMP]
        words = row[MW + hway[c] * NW : MW + (hway[c] + 1) * NW]
        assert ((words & shw[c]) == shw[c]).all()
    mesi = port_cfg(dataclasses.replace(jcfg, coherence="mesi"))
    t_mesi = _commit_both(dataclasses.replace(jcfg, coherence="mesi"), mesi,
                          _restage(jcfg, arrs))[1]
    assert not torch.equal(t_mesi[1], t_out[1])


# ------------------------------------------------------------ whole runs


@pytest.fixture(scope="module", params=ZOO_COMBOS, ids=lambda c: "-".join(c))
def zoo_run(request):
    """One port run and one run of each JAX reference per machine."""
    topology, coherence, prefetcher, gen = request.param
    cfg = zoo_cfg(
        topology=topology, coherence=coherence, prefetcher=prefetcher,
        prefetch_degree=4, prefetch_lat=3,
    )
    tr = _zoo_trace(gen)
    return cfg, tr, run_port(cfg, tr)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_zoo_whole_run_matches_the_jax_engine(zoo_run, impl):
    cfg, tr, te = zoo_run
    assert_engines_equal(run_jax(cfg, tr, impl=impl), te, impl)


def test_zoo_whole_run_matches_golden(zoo_run):
    cfg, tr, te = zoo_run
    assert_golden_equal(cfg, tr, te)
    if cfg.prefetcher == "stride" and cfg.coherence == "mesi":
        assert te.counters["prefetch_hits"].sum() > 0


def _home_entry(tcfg, st, line=0):
    tag, owner, _ = llc_views(tcfg, st)
    b, s = line & (tcfg.n_banks - 1), (line // tcfg.n_banks) & (tcfg.llc.sets - 1)
    w = int(np.nonzero(tag[b, s] == line)[0][0])
    words = sharers_view(tcfg, st).reshape(tcfg.n_banks, tcfg.llc.sets, tcfg.llc.ways, -1)
    bits = {c for c in range(tcfg.n_cores) if (int(words[b, s, w, c // 32]) >> (c % 32)) & 1}
    return int(owner[b, s, w]), bits


@pytest.mark.parametrize("coherence", ["moesi", "mesi"])
def test_owner_retained_on_gets_under_moesi_only(coherence):
    """tests/test_zoo.py's owner cases through the port: under MOESI the
    GETS probes the dirty owner and leaves it recorded with both cores as
    sharers (core 0's stored M line derives to Owned); under MESI the
    owner is demoted."""
    cfg = small_test_config(4, coherence=coherence)
    tr = _two_core_sharing_trace()
    te = run_port(cfg, tr)
    assert_engines_equal(run_jax(cfg, tr), te)
    assert int(te.counters["probes"][1]) == 1
    owner, sharers = _home_entry(te.cfg, te.state)
    _, l1_state, _, _ = l1_views(te.cfg, te.state)
    if coherence == "moesi":
        assert owner == 0 and sharers == {0, 1}
        assert (l1_state[0] == M).any()  # stored M, derived O
    else:
        assert owner == -1


def test_moesi_diverges_from_mesi_on_shared_readers():
    tr = synth.uniform_random(8, n_mem_ops=96, shared_frac=0.8, seed=11)
    probes = {}
    for proto in ("mesi", "moesi"):
        cfg = small_test_config(8, coherence=proto)
        te = run_port(cfg, tr)
        assert_engines_equal(run_jax(cfg, tr), te, proto)
        probes[proto] = int(te.counters["probes"].sum())
    assert probes["moesi"] > probes["mesi"]


def _descending_stream(n_cores=4, n_mem_ops=64):
    evs = []
    for c in range(n_cores):
        top = (1 + c) * (n_mem_ops * 64 + 4096) + n_mem_ops * 64
        core = []
        for i in range(n_mem_ops):
            core += [(EV_INS, 2, 0), (EV_LD, 4, top - i * 64)]
        evs.append(core)
    return from_event_lists(evs)


@pytest.mark.parametrize("direction", ["ascending", "descending"])
def test_stride_prefetcher_covers_streams(direction):
    """Covered misses pay prefetch_lat, skip DRAM's latency, and are
    still counted as DRAM accesses; a descending stream trains a negative
    stride (floor division of negative distances)."""
    tr = synth.stream(4, n_mem_ops=96, seed=3) if direction == "ascending" else _descending_stream()
    base = run_port(small_test_config(4), tr)
    cfg = small_test_config(4, prefetcher="stride", prefetch_degree=4, prefetch_lat=2)
    te = run_port(cfg, tr)
    assert_engines_equal(run_jax(cfg, tr), te)
    assert int(te.counters["prefetch_hits"].sum()) > 0
    np.testing.assert_array_equal(te.counters["dram_accesses"], base.counters["dram_accesses"])
    assert te.cycles.max() < base.cycles.max()
    if direction == "descending":
        assert (te.state.pf_stride < 0).all()


@pytest.mark.parametrize("topology", ["torus", "ring"])
def test_coarse_vector_on_torus_and_ring(topology):
    """Dir-G's group tables and self/owner corrections under the
    topology's hop counts, to the JAX engine (both steps) and golden."""
    cfg = zoo_cfg(16, 4, 4, topology=topology, sharer_group=4)
    te = assert_port_matches_everything(
        cfg, synth.false_sharing(16, n_mem_ops=30, seed=41), chunk_steps=32
    )
    assert te.counters["invalidations"].sum() > 0


def test_moesi_invariant_rejects_a_missing_owner_bit():
    """An owned entry with sharers passes under MOESI while it records the
    owner's own bit, and fails once that bit is cleared."""
    cfg = small_test_config(4, coherence="moesi")
    te = run_port(cfg, _two_core_sharing_trace())
    tcfg, st = te.cfg, te.state
    owner, sharers = _home_entry(tcfg, st)
    assert owner == 0 and sharers == {0, 1}
    check_invariants(tcfg, st)
    with pytest.raises(AssertionError, match="owned LLC entry has non-empty"):
        check_invariants(dataclasses.replace(tcfg, coherence="mesi"), st)
    bad = st._replace(dirm=st.dirm.clone())
    b, s = 0, 0
    tag, _, _ = llc_views(tcfg, st)
    w = int(np.nonzero(tag[b, s] == 0)[0][0])
    col = llc_meta_width(tcfg) + w * tcfg.n_sharer_words
    bad.dirm[b * tcfg.llc.sets + s, col] &= ~1  # core 0's bit
    with pytest.raises(AssertionError, match="moesi owned entry has sharers but no owner bit"):
        check_invariants(tcfg, bad)


def test_jax_state_with_prefetcher_arrays_resumes_in_the_port():
    """A JAX mid-run state with live pf_line/pf_stride/pf_streak crosses
    into the port (convert) and both packages run on from it to the same
    state."""
    cfg = zoo_cfg(topology="torus", coherence="moesi", prefetcher="stride",
                  prefetch_degree=4, prefetch_lat=3, step_impl="pallas")
    tr = synth.stream(8, n_mem_ops=96, seed=3)
    je = JEngine(cfg, tr, chunk_steps=24)
    je.run_steps(24)
    assert not je.done()
    arrays = jax_arrays(je.state)
    assert all((arrays[f] != 0).any() for f in ("pf_line", "pf_stride", "pf_streak"))
    tcfg = port_cfg(cfg)
    tst = convert.state_from_numpy(tcfg, arrays, "cpu")
    assert_states_equal(je.state, tst, "carried")
    events = torch.from_numpy(tr.line_events(cfg.line_bits))
    j_next = j_run_chunk(cfg, 40, je.events, je.state, has_sync=je.has_sync)
    t_next = t_engine.run_chunk(tcfg, 40, events, tst, has_sync=je.has_sync)
    assert_states_equal(j_next, t_next, "after 40 steps")
    assert not torch.equal(t_next.pf_line, tst.pf_line)


@pytest.mark.parametrize("model", ["link", "router"])
@pytest.mark.parametrize("topology", ["torus", "ring"])
def test_contention_routes_on_torus_and_ring(topology, model):
    """The per-link contention models walk the topology's routes
    (`noc.topology.path_links`): the wrap links of the torus, the ring's
    spine; the router model with the DRAM queue and the barrier-arrival
    leg, to the JAX engine (both steps) and golden."""
    cfg = small_test_config(
        16, n_banks=4, quantum=400, local_run_len=2, dram_queue=True,
        noc=NocConfig(mesh_x=4, mesh_y=4, link_lat=1, router_lat=2,
                      topology=topology, contention=True,
                      contention_model=model),
    )
    tr = synth.barrier_phases(16, n_phases=3, work_per_phase=6, seed=43)
    te = assert_port_matches_everything(cfg, tr, chunk_steps=32)
    assert te.counters["noc_contention_cycles"].sum() > 0
    assert te.counters["barrier_waits"].sum() > 0
