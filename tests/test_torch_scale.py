"""The port's large-core directory paths against the JAX package, on the
CPU: the chunked full map (`sharer_chunk_words` = K > 0, rung 4's
setting) and steps at rung 4's and rung 5's core counts.

Under K > 0 the JAX engine scans the packed sharer words in K-word
blocks; the port computes the same function in one pass (the full-map
`sharer_reductions`), so tests/test_scale.py's chunked machines (K = 1
and 2 on 64 cores, and K = 2 with barrier sync and tile contention) are
held through the port, the JAX engine (xla and pallas) and the golden
model, bit for bit. Then the first steps of tests/test_scale.py's
4096-core chunked machine (128 sharer words, K = 8) and 16384-core
coarse machine (G = 64, 256 groups) from their initial states, port
against JAX, every state field compared.
"""

import numpy as np
import pytest
import torch

from primesim_tpu.config.machine import CacheConfig, CoreConfig, MachineConfig, NocConfig
from primesim_tpu.sim.engine import run_chunk as j_run_chunk
from primesim_tpu.sim.state import init_state as j_init_state
from primesim_tpu.stats.counters import COUNTER_NAMES
from primesim_tpu.trace import synth
from primesim_tpu_torch.sim import engine as t_engine
from primesim_tpu_torch.sim.state import init_state as t_init_state

from test_parity_scale import scale_machine
from test_torch_engine import assert_port_matches_everything, assert_states_equal, port_cfg


@pytest.mark.parametrize("chunk", [1, 2])
def test_parity_chunked_sharers_64core(chunk):
    # NW = 2 at 64 cores: K = 1 scans two blocks, K = 2 one
    cfg = scale_machine(64, 8, 8, sharer_chunk_words=chunk)
    te = assert_port_matches_everything(
        cfg, synth.readers_writer(64, n_rounds=2, block_lines=4, seed=62),
        chunk_steps=64,
    )
    assert te.counters["invalidations"].sum() > 0


def test_parity_chunked_sharers_sync_and_contention():
    cfg = scale_machine(
        64, 8, 8, sharer_chunk_words=2,
        noc=NocConfig(mesh_x=8, mesh_y=8, contention=True, contention_lat=2),
    )
    te = assert_port_matches_everything(
        cfg, synth.barrier_phases(64, n_phases=2, work_per_phase=6, seed=63),
        chunk_steps=64,
    )
    assert te.counters["barrier_waits"].sum() > 0
    assert te.counters["noc_contention_cycles"].sum() > 0


def _scale_cfg(kind):
    """tests/test_scale.py's 4096-core chunked and 16384-core coarse
    machines (small caches), with their traces and step counts."""
    small_l1 = CacheConfig(size=1024, ways=2, line=64, latency=2)
    if kind == "4096_chunked":
        cfg = MachineConfig(
            n_cores=4096, n_banks=64, core=CoreConfig(cpi_pattern=(1, 1, 3, 3)),
            l1=small_l1, llc=CacheConfig(size=8192, ways=4, line=64, latency=12),
            noc=NocConfig(mesh_x=8, mesh_y=8), quantum=1000,
            sharer_chunk_words=8,
        )
        return cfg, synth.false_sharing(4096, n_mem_ops=6, n_hot_lines=2, seed=64), 8
    cfg = MachineConfig(
        n_cores=16384, n_banks=256, core=CoreConfig(o3_overlap_256=128),
        l1=small_l1, llc=CacheConfig(size=8192, ways=4, line=64, latency=16),
        noc=NocConfig(mesh_x=16, mesh_y=16), quantum=1000, sharer_group=64,
    )
    return cfg, synth.false_sharing(16384, n_mem_ops=4, n_hot_lines=2, seed=65), 4


@pytest.mark.parametrize("kind", ["4096_chunked", "16384_coarse"])
def test_first_steps_at_scale_match_jax(kind):
    import jax.numpy as jnp

    cfg, tr, n = _scale_cfg(kind)
    events = tr.line_events(cfg.line_bits)
    jst = j_run_chunk(cfg, n, jnp.asarray(events), j_init_state(cfg), has_sync=False)
    tcfg = port_cfg(cfg)
    tst = t_init_state(tcfg, "cpu")
    tev = torch.from_numpy(events)
    for _ in range(n):
        tst = t_engine.step(tcfg, tev, tst, has_sync=False)
    assert int(tst.step) == n
    assert_states_equal(jst, tst, kind)
    cnt = tst.counters.numpy()
    assert cnt[COUNTER_NAMES.index("instructions")].sum() > 0
    assert cnt[COUNTER_NAMES.index("retries")].sum() > 0  # hot lines contend
    if kind == "4096_chunked":
        assert cfg.n_sharer_words == 128
    else:
        assert (cfg.n_sharer_groups, cfg.n_sharer_words) == (256, 8)
