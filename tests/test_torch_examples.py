"""The port's examples (``deepearth_tpu_torch/examples/``) on the CPU.

Each example's ``main(device="cpu")`` runs in a fresh process in which
``jax``, ``flax`` and the JAX package cannot be imported, and prints its
pass line (its own checks: the spatial decode in [0, 1] and the loss
falling; the dense-grid correlation above 0.9; the probe and the ecosystem
clusters). The density field runs 150 of its 300 steps here (its fit
passes 0.9 by then; the card runs all 300 in ``chip_smoke.py`` phase 24).
Their first steps against the JAX examples' are in
``tests/test_torch_examples_jax.py``.
"""

import os
import subprocess
import sys

import pytest
import torch

from deepearth_tpu_torch.examples import density_field, quick_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = (
    "import importlib.abc, sys, torch\n"
    "torch.set_num_threads(3)\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
    "'deepearth_tpu'):\n"
    "            raise ImportError(name)\n"
    "sys.meta_path.insert(0, Block())\n")


def run_example(name: str, **kwargs) -> str:
    code = (BLOCK_JAX
            + f"from deepearth_tpu_torch.examples import {name}\n"
            + f"{name}.main(device='cpu', **{kwargs!r})\n"
            + "bad = [n for n in sys.modules if n.split('.')[0] in "
              "('jax', 'flax', 'deepearth_tpu')]\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("name,kwargs,line", [
    ("quick_test", {}, "quick test passed ✓"),
    ("density_field", {"steps": 150}, "density field example passed ✓"),
    ("florida_pipeline", {}, "pipeline demo completed in"),
])
def test_example_runs_on_the_cpu_without_jax(name, kwargs, line):
    if name == "florida_pipeline":
        for module in ("pandas", "pyarrow", "sklearn"):
            pytest.importorskip(module)
    assert line in run_example(name, **kwargs)


def test_examples_refuse_the_default_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    for main in (quick_test.main, density_field.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
