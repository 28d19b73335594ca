"""The port's RoPE tables in fresh processes.

Torch's first threaded fp32 cos on the CPU in a process now and then keeps
only about half the mantissa (~1.5e-4 off at 16 x 600 angles), so a parity
test that runs first in an xdist worker could read the RoPE tables that far
from JAX's. ``ops/rope.py`` therefore takes cos and sin of the fp32 angles
in float64 and rounds once. The test holds the port's tables, made first
thing in fresh processes, to float64. Run as a script, the module counts
how often each way of taking cos is off:

    python tests/test_torch_rope_fresh_process.py [--procs 240] [--parallel 6]

Modes: torch's fp32 cos, torch's float64 cos, torch's fp32 cos with one
OpenMP thread, and the port's rope_cos_sin (fp32 out). Each probe is a fresh
Python process that takes cos twice of the fp32 angle table of a 16-wide
RoPE over 600 positions (the case of
test_torch_deepseek.py::test_rope_tables_match_jax[16-none-half]) and
prints each call's largest difference from float64. A first call counts as
off beyond 1e-6 for an fp32 result (~16 fp32 ulps of 1), 1e-12 for a
float64 one.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import sys
import numpy as np
import torch
mode = sys.argv[1]
t = torch.arange(600, dtype=torch.float32)
inv = 1.0 / (10000.0 ** (torch.arange(0, 16, 2, dtype=torch.float32) / 16))
emb = torch.outer(t, inv).repeat(1, 2)
ref = np.cos(emb.numpy().astype(np.float64))
if mode == "port":
    sys.path.insert(0, sys.argv[2])
    from deepearth_tpu_torch.configs import RopeScalingConfig
    from deepearth_tpu_torch.ops.rope import rope_cos_sin
    calls = [rope_cos_sin(600, 16, 10000.0, RopeScalingConfig(type="none"),
                          "half")[0] for _ in range(2)]
else:
    x = emb.double() if mode == "fp64" else emb
    calls = [torch.cos(x) for _ in range(2)]
print(*(float(np.abs(c.double().numpy() - ref).max()) for c in calls))
"""

MODES = {"fp32": {}, "fp64": {}, "fp32, OMP_NUM_THREADS=1":
         {"OMP_NUM_THREADS": "1"}, "port": {}}
LIMIT = {"fp64": 1e-12}  # else 1e-6


def probe(mode: str) -> tuple:
    """(first call's, second call's) largest difference from float64 in
    one fresh process."""
    env = {**os.environ, **MODES[mode]}
    out = subprocess.run([sys.executable, "-c", PROBE, mode.split(",")[0],
                          REPO], env=env, capture_output=True, text=True,
                         check=True).stdout.split()
    return tuple(float(v) for v in out)


def test_port_rope_tables_hold_in_fresh_processes():
    with ThreadPoolExecutor(4) as pool:
        reads = list(pool.map(probe, ["port"] * 8))
    assert max(max(r) for r in reads) <= 1e-6, reads


REPEAT = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
from deepearth_tpu_torch.configs import RopeScalingConfig
from deepearth_tpu_torch.ops.rope import rope_cos_sin
same = True
for dim in (16, 64):
    for layout in ("half", "interleaved"):
        a, b = (rope_cos_sin(600, dim, 10000.0, RopeScalingConfig(), layout)
                for _ in range(2))
        same &= all(torch.equal(x, y) for x, y in zip(a, b))
print(same)
"""


def test_port_rope_tables_repeat_bit_for_bit_in_fresh_processes():
    """A process's first tables equal its second bit for bit (the cached
    tables of ``rope_tables`` are a first call's), with 6 processes
    starting at once as xdist workers do."""
    def run(_):
        return subprocess.run([sys.executable, "-c", REPEAT, REPO],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    with ThreadPoolExecutor(6) as pool:
        reads = list(pool.map(run, range(12)))
    assert reads == ["True"] * 12, reads


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--procs", type=int, default=240)
    parser.add_argument("--parallel", type=int, default=6)
    args = parser.parse_args()
    for mode in MODES:
        with ThreadPoolExecutor(args.parallel) as pool:
            reads = list(pool.map(probe, [mode] * args.procs))
        limit = LIMIT.get(mode, 1e-6)
        off = collections.Counter(f"{first:.3g}" for first, _ in reads
                                  if first > limit)
        print(f"{mode}: {sum(off.values())} of {args.procs} processes' "
              f"first call more than {limit:g} from float64 (by error: "
              f"{dict(off)}); second calls at most "
              f"{max(second for _, second in reads):.3g}; first calls "
              f"otherwise at most "
              f"{max(f for f, _ in reads if f <= limit):.3g}")


if __name__ == "__main__":
    main()
