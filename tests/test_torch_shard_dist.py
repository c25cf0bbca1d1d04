"""The sharded covariant tiers across processes (slow: subprocess
workers, ``scripts/check_tiers.py`` rule 2).

* The ``torch.distributed`` transport: the face tier over six gloo CPU
  processes, one rank each (``tests/torch_shard_dist_worker.py``),
  against the same tier on six virtual ranks in this process, 3 steps at
  C8, serialized and overlapped: bitwise (the same operations on the
  same values; only the transport differs), each rank's block and the
  all-gathered global state.
* The block tier against the JAX package's on 24 virtual devices at C16
  (``tests/torch_cov_block_worker.py``), 3 steps of dt = 300 s,
  serialized and overlapped: 1e-6 of each field's max.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.parallel.mesh import (setup_sharding, shard_state,
                                           unshard_state)
from jaxstream_torch.parallel.sharded_model import make_stepper_for
from jaxstream_torch.physics.initial_conditions import williamson_tc5

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_shard_dist_worker.py")
BLOCK_WORKER = os.path.join(HERE, "torch_cov_block_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serialized", "overlapped"])
def test_process_group_transport_matches_virtual_ranks(tmp_path, overlap):
    world = 6
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port),
         str(tmp_path), "1" if overlap else "0"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (r, logs[r][-3000:])

    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b)
    setup = setup_sharding({"parallelization": {
        "num_devices": world, "use_shard_map": True,
        "overlap_exchange": overlap}}, device="cpu")
    step = make_stepper_for(m, setup, None, 600.0)
    y = shard_state(setup, m.initial_state(h, v))
    for _ in range(3):
        y = step(y, 0.0)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k in ("h", "u"):
            assert np.array_equal(got[k], y[k][r:r + 1].numpy()), (r, k)
    full = unshard_state(setup, y)
    got = np.load(tmp_path / "global.npz")
    for k in ("h", "u"):
        assert torch.equal(torch.from_numpy(got[k]), full[k]), k


@pytest.mark.slow
def test_block_tier_matches_jax_on_24_devices():
    proc = subprocess.run([sys.executable, BLOCK_WORKER],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "TORCH_COV_BLOCK_OK" in proc.stdout, proc.stdout[-3000:]
