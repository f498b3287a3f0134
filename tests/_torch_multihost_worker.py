"""Worker of ``tests/test_torch_multihost.py``: one of two processes that
take one data-parallel training step of the port together.

    python tests/_torch_multihost_worker.py <rank> <nprocs> <port> <outfile>

Each process joins a ``gloo`` process group on ``127.0.0.1:<port>``,
builds a 2-replica mesh that names the CPU twice, feeds its own half of
the sample set (``shard_host_local_batch``), runs one step of
``make_train_step(cfg, mesh=…)`` and writes the new weights to
``<outfile>`` (npz). The architecture and data are
``tests/_multihost_worker.py``'s (its JAX counterpart). Imports no JAX.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    rank, nprocs, port, outfile = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4])
    sys.path[:0] = [os.path.dirname(HERE), HERE]

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from _multihost_worker import CFG  # imports JAX only inside its main
    from cnn_sr_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        process_count,
        shard_host_local_batch,
    )
    from cnn_sr_tpu_torch.training.trainer import init_train_state, make_train_step
    from cnn_sr_tpu_torch.utils.config import parse_config
    from cnn_sr_tpu_torch.utils.params_io import params_to_torch

    assert initialize_multihost(f"127.0.0.1:{port}", nprocs, rank, backend="gloo")
    assert initialize_multihost(f"127.0.0.1:{port}", nprocs, rank, backend="gloo")
    assert process_count() == nprocs

    cfg = parse_config(CFG)
    state = init_train_state(cfg, seed=0)  # the same seed: the same start everywhere
    rng = np.random.default_rng(42)  # the whole sample set, drawn alike everywhere
    inputs = rng.random((2 * nprocs, 16, 16, 1), np.float32)
    gts = rng.random((2 * nprocs, 16, 16, 1), np.float32)

    cpu = torch.device("cpu")
    mesh = make_mesh(n_data=2, devices=[cpu, cpu])
    lo, hi = 2 * rank, 2 * (rank + 1)  # this process feeds only its own half
    xs = shard_host_local_batch(mesh, torch.from_numpy(inputs[lo:hi]))
    ts = shard_host_local_batch(mesh, torch.from_numpy(gts[lo:hi]))
    params = params_to_torch(state.params, cpu)
    prev = params_to_torch(state.prev_delta, cpu)
    new_params, _ = make_train_step(cfg, mesh=mesh)(params, prev, xs, ts)

    np.savez(outfile,
             **{f"w{i}": l["w"].numpy() for i, l in enumerate(new_params)},
             **{f"b{i}": l["b"].numpy() for i, l in enumerate(new_params)})
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"worker {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
