"""The benchmark of ``cnn_sr_tpu_torch`` on one NVIDIA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json``   the model's sizes, its weights (a
  checkpoint file or ``inits/<init>.py`` with a seed) and the checksum
  that pins them, the colour pipeline it runs, and its plain reference
  ``reference/<reference>.py``, which may count the model's operations
  and bytes;
* ``traffic/<traffic>.json``  a mix as data: its ``loop`` names the loop
  that drives it (``loops/<loop>.py``: ``closed_batch``, batches back to
  back; ``open_serve``, requests at fixed arrivals), the rest are that
  loop's parameters;
* ``limits/<cell>.json``      the numbers that decide ``correct``, their
  limits and the readings they were set from;
* ``metrics/<name>.py``       the reader of one per-layer metric (the name
  up to its first dot: ``latency_p95_ms.serve`` reads
  ``metrics/latency_p95_ms.py``);
* ``reference/``              the plain PyTorch pipeline, which imports
  nothing of the program.

The yardstick (frames, operation and byte counts, peaks, trace arithmetic,
the reference and the comparison) lives here so that a change to the
program cannot move it. Nothing here imports JAX or ``cnn_sr_tpu``.
"""

import os

# The host threads of every process that measures a cell: four OpenMP
# workers that sleep when idle. Torch's default on the card's 8-core host,
# eight workers that spin between parallel regions, takes cores from the
# thread that launches the work and waits on the card, and a closed loop's
# rate then swings from process to process. Set before torch is imported.
HOST_THREADS = {"OMP_NUM_THREADS": "4", "OMP_WAIT_POLICY": "PASSIVE"}


def set_host_threads() -> None:
    """Give this process ``HOST_THREADS``; call it before importing torch."""
    os.environ.update(HOST_THREADS)
