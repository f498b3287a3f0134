"""Profiling on the card: the op table of a 1080p request names the
hand-written kernel, ``warn_blocking_transfers`` warns at a host-blocking
copy, and ``print_device_memory`` reads the card. The CPU side is held
against the JAX package by ``test_torch_profiling.py``.

These tests need a card and carry the ``cuda`` marker; a machine with a
card may have no JAX, so this module imports none:

    python -m pytest tests/test_torch_profiling_card.py -m cuda --noconftest
"""

import os
import warnings

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch import api, profiling
from cnn_sr_tpu_torch.ops.fused import entry
from cnn_sr_tpu_torch.utils import debug
from cnn_sr_tpu_torch.utils.config import read_config
from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_op_table_of_a_1080p_bf16_request_names_the_fused_kernel(cuda_device, tmp_path):
    cfg = read_config(os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json"))
    params = params_to_torch(init_params(cfg)[0], cuda_device)
    rgba = np.random.default_rng(0).integers(0, 256, (1080, 1920, 4), dtype=np.uint8)
    api.upscale_image(cfg, params, rgba, precision="bf16")  # the library's first load
    prof = profiling.StageProfiler(profile_dir=str(tmp_path))
    before = entry.LAUNCHES_BF16
    prof.start_trace()
    out = prof.timed("upscale", api.upscale_image, cfg, params, rgba, precision="bf16")
    prof.stop_trace()
    assert out.shape == (1080, 1920, 3) and entry.LAUNCHES_BF16 == before + 1
    rows = profiling.op_shares(str(tmp_path))
    fused = [(name, t, n) for name, t, n in rows if "fused_wgmma_kernel" in name]
    assert len(fused) == 1 and fused[0][2] == 1, rows[:5]
    assert fused[0][1] > 0 and any(name.startswith("Memcpy") for name, _, _ in rows)
    busy = profiling.idle_share(str(tmp_path))
    assert 0 < busy["busy"] <= busy["span"] <= busy["window"]


@pytest.mark.cuda
def test_warn_blocking_transfers_warns_at_a_copy_to_the_host(cuda_device):
    x = torch.ones(1024, device=cuda_device)
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with debug.warn_blocking_transfers(True, cuda_device):
            assert torch.cuda.get_sync_debug_mode() == 1
            (x * 2).cpu()
    assert torch.cuda.get_sync_debug_mode() == previous
    assert any("synchronizing" in str(w.message) for w in seen), [str(w.message) for w in seen]


@pytest.mark.cuda
def test_print_device_memory_prints_a_limit(cuda_device):
    x = torch.ones(1 << 20, device=cuda_device)
    lines = []
    profiling.print_device_memory(log=lines.append, device=cuda_device)
    assert len(lines) == torch.cuda.device_count() and x.numel()
    assert lines[0].startswith("[cuda:0] device memory: ") and ", limit " in lines[0]
