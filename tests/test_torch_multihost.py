"""Two-process data parallelism of the port over ``torch.distributed``
(``gloo`` on the CPU), the counterpart of ``tests/test_multihost.py``.

Two workers (``tests/_torch_multihost_worker.py``), each with a 2-replica
CPU mesh, feed their halves of the sample set and take one step of
``make_train_step(cfg, mesh=…)`` together. Their parameters must be equal
bit for bit (``all_reduce`` gives every rank the same sum), equal to the
port's single-process step over a 4-replica mesh and to JAX's over four
devices, both within tests/test_multihost.py's rtol 1e-6, atol 1e-7.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from _multihost_worker import CFG
from cnn_sr_tpu.parallel.mesh import make_mesh as jmake_mesh
from cnn_sr_tpu.training import trainer as jtrainer
from cnn_sr_tpu.utils.config import parse_config as jparse_config
from cnn_sr_tpu_torch.parallel import make_mesh
from cnn_sr_tpu_torch.training import trainer
from cnn_sr_tpu_torch.utils.config import parse_config
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "_torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data():
    rng = np.random.default_rng(42)
    return rng.random((4, 16, 16, 1), np.float32), rng.random((4, 16, 16, 1), np.float32)


def test_two_process_data_parallel_step(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"w{i}.npz") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen([sys.executable, _WORKER, str(i), "2", str(port), outs[i]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a multihost worker ran out of its 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    a, b = np.load(outs[0]), np.load(outs[1])
    assert set(a.files) == set(b.files) and len(a.files) == 6
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} differs across processes")

    inputs, gts = _data()
    cfg = parse_config(CFG)
    state = trainer.init_train_state(cfg, seed=0)
    cpu = torch.device("cpu")
    mine, _ = trainer.make_train_step(cfg, mesh=make_mesh(4, devices=[cpu] * 4))(
        params_to_torch(state.params, cpu), params_to_torch(state.prev_delta, cpu),
        torch.from_numpy(inputs), torch.from_numpy(gts))
    jstate = jtrainer.init_train_state(jparse_config(CFG), seed=0)
    jmesh = jmake_mesh(n_data=4, devices=jax.devices()[:4])
    theirs, _ = jtrainer.make_train_step(jparse_config(CFG), mesh=jmesh)(
        jstate.params, jstate.prev_delta, inputs, gts)
    for i in range(3):
        for key, ref in ((f"w{i}", mine[i]["w"].numpy()), (f"b{i}", mine[i]["b"].numpy()),
                         (f"w{i}", np.asarray(theirs[i]["w"])),
                         (f"b{i}", np.asarray(theirs[i]["b"]))):
            np.testing.assert_allclose(a[key], ref, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{key}: two processes vs one")
