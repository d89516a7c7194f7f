"""Two processes, one tile mesh: `parallel/distributed.py` over a gloo
process group on 127.0.0.1, each process holding 2 of the 4 shards of
tests/test_multihost.py's machine (8 cores, false_sharing, seed 77). The
step's exchange runs over the group (all-gathers and all-reduces), and
the result must equal the unsharded JAX engine's, bit for bit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys
from primesim_tpu_torch.parallel.distributed import (
    global_tile_mesh, init_multi_host, process_info,
)

coord, nproc, pid, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
init_multi_host(coord, nproc, pid, backend="gloo")
info = process_info()
assert info["process_count"] == nproc, info
assert info["global_devices"] == 2 * nproc, info

from primesim_tpu_torch.config.machine import small_test_config
from primesim_tpu_torch.sim.engine import Engine
from primesim_tpu_torch.trace import synth

cfg = small_test_config(8, n_banks=8, quantum=400)
tr = synth.false_sharing(8, n_mem_ops=24, seed=77)
mesh = global_tile_mesh("cpu")
assert mesh.size == 2 * nproc and len(mesh.local) == 2
eng = Engine(cfg, tr, chunk_steps=16, mesh=mesh)
eng.run()
# every process computes the same global result; process 0 reports
cycles = [int(x) for x in eng.cycles]
counters = {k: [int(x) for x in v] for k, v in eng.counters.items()}
if pid == 0:
    with open(out, "w") as f:
        json.dump({"cycles": cycles, "counters": counters, "info": info,
                   "steps": eng.steps_run}, f)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.timeout(300)
def test_two_process_gloo_bit_exact(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    out = str(tmp_path / "result.json")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, "2", str(pid), out],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    try:
        for p in procs:
            rc = p.wait(timeout=240)
            if rc != 0:
                raise AssertionError(f"worker exited {rc}\nstderr:\n{p.stderr.read()[-4000:]}")
    finally:
        for p in procs:
            p.kill()
    with open(out) as f:
        got = json.load(f)
    assert got["info"]["process_count"] == 2
    assert got["info"]["global_devices"] == 4
    assert got["info"]["local_devices"] == 2

    from primesim_tpu.config.machine import small_test_config
    from primesim_tpu.sim.engine import Engine as JEngine
    from primesim_tpu.trace import synth

    ref = JEngine(small_test_config(8, n_banks=8, quantum=400),
                  synth.false_sharing(8, n_mem_ops=24, seed=77), chunk_steps=16)
    ref.run()
    assert got["steps"] == ref.steps_run
    np.testing.assert_array_equal(np.asarray(got["cycles"]), np.asarray(ref.cycles))
    for k, v in ref.counters.items():
        np.testing.assert_array_equal(np.asarray(got["counters"][k]), np.asarray(v),
                                      err_msg=k)
