"""``run.py`` refuses to print a result where it must: without a card, and
in a directory that holds only ``BENCHMARK.json`` and the benchmark."""

import shutil
import subprocess
import sys

import pytest

from benchmark import core

ARGS = ["--workload", "srcnn955-bf16-frames1080-b8", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=str(cwd),
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(core.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(core.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_workload():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope", "--seed",
                          "1", "--seconds", "1"], cwd=str(core.ROOT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_host_threads_set_before_torch():
    """``run.py`` gives its process the benchmark's host threads before
    torch is imported, so torch's pool takes them."""
    code = ("import runpy; runpy.run_path('benchmark/run.py'); import os, torch, benchmark; "
            "print(torch.get_num_threads(), os.environ['OMP_WAIT_POLICY'], "
            "benchmark.HOST_THREADS['OMP_NUM_THREADS'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(core.ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, policy, want = out.stdout.split()
    assert (n, policy) == (want, "PASSIVE")
