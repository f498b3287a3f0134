"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import subprocess
import sys

from benchmark import core

RUN_TINY = """
import sys
sys.path.insert(0, {root!r})
from benchmark import core
core.run_cell("srcnn955-bf16-frames1080-b8", 2**31 + 11, 0.2, False, device="cpu",
              overrides={{"h": 30, "w": 40, "batch": 2, "pool_batches": 1}}, log=lambda m: None)
print(core.forbidden_modules())
"""

REF_ONLY = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.srcnn
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"cnn_sr_tpu_torch", "cnn_sr_tpu", "jax", "jaxlib", "flax"}}))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(core.ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    assert _run(RUN_TINY) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    assert _run(REF_ONLY) == "[]"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cnn_sr_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert core.forbidden_modules() == [] or set(core.forbidden_modules()) <= set(core.FORBIDDEN)
    before = set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "cnn_sr_tpu.fake", sys)
    assert set(core.forbidden_modules()) - before == {"cnn_sr_tpu"}
