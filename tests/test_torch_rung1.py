"""The port on the shipped rung-1 machine (configs/rung1_64core_fft.json,
64 cores, two sharer words, an 8x8 mesh) against the JAX engine with
both step bodies and the golden model: local runs off and at the
config's 8, a folded and an unfolded trace, with and without sync
events. Bit-exact, as in tests/test_torch_engine.py."""

import dataclasses
import os

import pytest

from primesim_tpu.config.machine import MachineConfig
from primesim_tpu.trace import synth
from primesim_tpu.trace.format import fold_ins

from test_torch_engine import assert_port_matches_everything

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rung1(**kw):
    with open(os.path.join(REPO, "configs", "rung1_64core_fft.json")) as f:
        return dataclasses.replace(MachineConfig.from_json(f.read()), **kw)


TRACES = {
    "fft": lambda: synth.fft_like(64, n_phases=2, points_per_core=16, seed=7),
    "fft_folded": lambda: fold_ins(
        synth.fft_like(64, n_phases=2, points_per_core=16, seed=7)
    ),
    "barriers": lambda: synth.barrier_phases(
        64, n_phases=2, work_per_phase=6, seed=9
    ),
}


@pytest.mark.parametrize(
    "trace,rl",
    [("fft", 0), ("fft_folded", 8), ("barriers", 0), ("barriers", 8)],
)
def test_rung1_matches_jax_and_golden(trace, rl):
    te = assert_port_matches_everything(
        rung1(local_run_len=rl), TRACES[trace](), chunk_steps=64
    )
    assert te.counters["instructions"].sum() > 0
    if trace == "barriers":
        assert te.counters["barrier_waits"].sum() == 64 * 2
