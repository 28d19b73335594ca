"""The port's sharding rules, mesh helpers and ``cli.train --distributed``
against the JAX package, on the CPU.

``param_spec`` / ``make_param_shardings`` leaf for leaf against JAX's over
the tiny flagship tree of ``__graft_entry__.py`` (``dryrun_multichip``'s
``make_cfg``, as the port's model writes it with ``flax_params_from_model``;
its pipelined variant for the 'pipe' meshes), on meshes (1, 1, 1),
(2, 2, 2), (8,), ('data', 'pipe') (2, 4) and (4, 2), with and without
``fsdp_axes=('data', 'expert')``: the specs equal, each leaf's local
element count equal to JAX's ``addressable_shards``; the placements on the
port's tensors (transposed kernels) give the same blocks; ``_factorize``,
``process_local_batch_indices``; the new modules import
where ``jax`` is blocked; and ``cli.train --distributed --device cpu``
under a 2-rank gloo launch (``file://`` rendezvous in ``tmp_path``).
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_legs as L  # noqa: E402
from deepearth_tpu.parallel import mesh as jmesh  # noqa: E402
from deepearth_tpu_torch import flax_params_from_model  # noqa: E402
from deepearth_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    make_param_shardings,
    param_spec,
    process_local_batch_indices,
)
from deepearth_tpu_torch.parallel import mesh as pmesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [
    ((1, 1, 1), ("data", "expert", "model")),
    ((2, 2, 2), ("data", "expert", "model")),
    ((8,), ("data",)),
    ((2, 4), ("data", "pipe")),
    ((4, 2), ("data", "pipe")),
]


@pytest.fixture(scope="module")
def trees():
    """The tiny flagship's flax tree, sequential and pipelined (2 stages)."""
    seq = flax_params_from_model(L.make_model(L.make_cfg()))
    pp = flax_params_from_model(L.pipelined_model(L.make_cfg(
        pipeline_stages=2)))
    return {"seq": seq, "pp": pp}


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("fsdp", [(), ("data", "expert")])
@pytest.mark.parametrize("shape,axes", MESHES)
def test_make_param_shardings_match_jax(trees, shape, axes, fsdp):
    tree = trees["pp" if "pipe" in axes else "seq"]
    n = math.prod(shape)
    jm = jmesh.create_mesh(jax.devices()[:n], mesh_shape=shape,
                           axis_names=axes)
    pm = Mesh(axes, shape)
    jsh = jmesh.make_param_shardings(tree, jm, fsdp)
    psh = make_param_shardings(tree, pm, fsdp)
    n_sharded = 0
    for path, leaf in leaves(tree):
        js, ps = get(jsh, path), get(psh, path)
        assert tuple(js.spec) == ps.spec, (path, js.spec, ps.spec)
        assert ps.spec == param_spec("/".join(path), leaf.shape, pm, fsdp)
        want = int(np.prod(js.shard_shape(leaf.shape)))
        block = ps.local_slices(leaf.shape)
        assert int(np.prod([s.stop - s.start for s in block])) == want, path
        n_sharded += want < leaf.size
    # the meshes where JAX's rules shard some leaf
    if (fsdp and n > 1) or shape in ((2, 2, 2), (4, 2)):
        assert n_sharded > 0


@pytest.mark.parametrize("fsdp", [(), ("data", "expert")])
def test_local_numel_equals_addressable_shards(trees, fsdp):
    """On (2, 2, 2) the block of every leaf holds as many elements as each
    of JAX's addressable shards of the placed array."""
    jm = jmesh.create_mesh(jax.devices()[:8], mesh_shape=(2, 2, 2))
    pm = Mesh(("data", "expert", "model"), (2, 2, 2))
    for path, leaf in leaves(trees["seq"]):
        spec = jmesh.param_spec("/".join(path), leaf.shape, jm, fsdp)
        placed = jax.device_put(jnp.asarray(leaf),
                                jax.sharding.NamedSharding(jm, spec))
        sizes = {s.data.size for s in placed.addressable_shards}
        ps = make_param_shardings({"x": leaf}, pm, fsdp)["x"]
        ps = pmesh.Sharding(pm, param_spec("/".join(path), leaf.shape, pm,
                                           fsdp), ps.placements)
        block = pmesh.local_slices(pm, pmesh.placements_for(ps.spec, pm),
                                   leaf.shape)
        assert sizes == {int(np.prod([s.stop - s.start for s in block]))}


def test_rules_on_their_own():
    """JAX's test_param_spec_rules and test_fsdp_extension cases."""
    ms = {"data": 2, "expert": 2, "model": 2}
    assert param_spec("moe/w_gate", (4, 64, 128), ms) == (
        "expert", None, "model")
    assert param_spec("moe/w_down", (4, 128, 64), ms) == (
        "expert", "model", None)
    assert param_spec("spatial/tables", (8, 1024, 2), ms) == ()
    assert param_spec("mlp/kernel", (512, 2048), ms) == (None, "model")
    assert param_spec("mlp/kernel", (16, 32), ms) == ()
    assert param_spec("moe/w_gate", (3, 64, 128), ms) == (
        None, None, "model")
    fsdp = ("data", "expert")
    for path, shape, factor in (("moe/w_gate", (4, 64, 128), 8),
                                ("moe/w_down", (4, 128, 64), 8),
                                ("mlp/kernel", (512, 2048), 8),
                                ("norm/scale", (64,), 4)):
        spec = param_spec(path, shape, ms, fsdp)
        flat = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        assert len(flat) == len(set(flat))
        assert math.prod(ms[a] for a in flat) == factor
        assert spec == tuple(jmesh.param_spec(path, shape, jmesh.create_mesh(
            jax.devices()[:8]), fsdp))
    assert param_spec("spatial/tables", (8, 1024, 2), ms, fsdp) == ()
    assert param_spec("norm/scale", (7,), ms, fsdp) == ()
    ms_pipe = {"data": 4, "pipe": 2}
    assert param_spec("pipe/stages/layer_0/mlp/kernel", (2, 512, 2048),
                      ms_pipe) == ("pipe", None, None)


def test_port_placements_follow_the_transposed_kernel():
    """A Dense kernel (in, out) is the port's (out, in) weight: its spec's
    dims map onto the port's reversed dims."""
    model = L.make_model(L.make_cfg())
    pm = Mesh(("data", "expert", "model"), (2, 2, 2))
    shard = make_param_shardings(model, pm, ("data", "expert"))
    layouts = pmesh.module_leaf_layouts(model)
    params = dict(model.named_parameters())
    for name, (path, fshape, perm) in layouts.items():
        sh = shard[name]
        assert sh.spec == param_spec(path, fshape, pm, ("data", "expert"))
        port_block = [s.stop - s.start
                      for s in sh.local_slices(params[name].shape)]
        flax_block = [s.stop - s.start for s in pmesh.local_slices(
            pm, pmesh.placements_for(sh.spec, pm), fshape)]
        assert [port_block[perm[i]] for i in range(len(perm))] == flax_block


@pytest.mark.parametrize("n,axes", [(1, 3), (2, 3), (4, 3), (6, 3), (8, 3),
                                    (16, 3), (8, 1), (12, 2)])
def test_factorize(n, axes):
    try:
        want = jmesh._factorize(n, axes)
    except IndexError:  # two axes: JAX's peel indexes a third
        with pytest.raises(IndexError):
            pmesh._factorize(n, axes)
        return
    assert pmesh._factorize(n, axes) == want


@pytest.mark.parametrize("n_total,count", [(10, 3), (8, 4), (7, 2), (5, 8)])
def test_process_local_batch_indices(n_total, count):
    for i in range(count):
        np.testing.assert_array_equal(
            process_local_batch_indices(n_total, i, count),
            jmesh.process_local_batch_indices(n_total, i, count))


def test_new_modules_import_without_jax(tmp_path):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'optax', "
        "'deepearth_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import deepearth_tpu_torch.parallel, deepearth_tpu_torch.ops.sharding\n"
        "import deepearth_tpu_torch.training.distributed\n"
        "import deepearth_tpu_torch.parallel.ring, "
        "deepearth_tpu_torch.parallel.pipeline\n"
        "assert not any(m.split('.')[0] in ('jax', 'deepearth_tpu') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env={**os.environ,
                                                 "PYTHONPATH": ROOT})
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-3000:]


def test_cli_train_distributed_two_ranks(tmp_path):
    """``cli.train --distributed --device cpu`` under 2 gloo ranks (the JAX
    script's variables: COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID):
    both ranks train and report the same global metrics."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT, NUM_PROCESSES="2",
               COORDINATOR_ADDRESS=f"file://{tmp_path}/store")
    procs, logs = [], [tmp_path / f"log{r}" for r in range(2)]
    for r in range(2):
        with open(logs[r], "w") as log:  # a file: a full pipe would stall
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deepearth_tpu_torch.cli.train",
                 "--distributed", "--device", "cpu", "--steps", "2",
                 "--batch-size", "8", "--hidden-dim", "64", "--n-layers",
                 "1", "--log-every", "1", "--metrics-jsonl",
                 str(tmp_path / f"m{r}.jsonl")],
                env={**env, "PROCESS_ID": str(r)}, cwd=str(tmp_path),
                stdout=log, stderr=subprocess.STDOUT))
    for p, log in zip(procs, logs):
        try:
            p.wait(timeout=240)
        finally:
            if p.poll() is None:
                for q in procs:
                    q.kill()
        assert p.returncode == 0, log.read_text()[-3000:]
    import json

    lines = [json.loads((tmp_path / f"m{r}.jsonl").read_text())
             for r in range(2)]
    for line in lines:
        line.pop("time")
    assert lines[0] == lines[1] and lines[0]["step"] == 2
    assert np.isfinite(lines[0]["loss/total"])
