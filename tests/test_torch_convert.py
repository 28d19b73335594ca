"""The flax -> torch parameter converter, the JSON config bridge, and the
port's independence from JAX."""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu_torch import (
    config_from_json,
    config_to_json,
    kernels,
    load_flax_params,
)
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.ops import (
    flash_attention,
    grouped_matmul,
    hash_encode,
    pairwise_token_attention,
    quant,
    vmem_attention,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    """A small JAX config, its flax params as numpy, and the ported config."""
    cfg = jcfg.DeepEarthConfig(
        hidden_dim=64, n_heads=4, n_layers=3,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=2, n_temporal_levels=2,
                                 hash_table_size=2 ** 8),
        compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=10))
    batch = {"xyzt": jnp.full((2, 4), 0.5),
             "modalities": {"species": jnp.zeros((2,), jnp.int32)}}
    params = JaxModel(cfg).init(jax.random.PRNGKey(0), batch)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, config_from_json(jcfg.config_to_json(cfg))


def fresh(cfg):
    return DeepEarthModel(cfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")


def test_load_is_total_and_copies_every_leaf(small):
    tree, cfg = small
    model = fresh(cfg)
    load_flax_params(model, tree)
    params = dict(model.named_parameters())
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert n_leaves == len(params)
    np.testing.assert_array_equal(
        params["fusion.layer_0.self_attn.q_proj.weight"].detach().numpy(),
        tree["fusion"]["layer_0"]["self_attn"]["q_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        params["grid4d.spatial.tables"].detach().numpy(),
        tree["grid4d"]["spatial"]["tables"])
    np.testing.assert_array_equal(
        params["embed_species.weight"].detach().numpy(),
        tree["embed_species"]["embedding"])
    np.testing.assert_array_equal(
        params["fusion.final_norm.weight"].detach().numpy(),
        tree["fusion"]["final_norm"]["scale"])


def _broken(tree, how):
    tree = copy.deepcopy(tree)
    if how == "leftover_leaf":
        tree["fusion"]["layer_1"]["cross_attn"] = {
            "q_proj": {"kernel": np.zeros((64, 64), np.float32)}}
    elif how == "missing_leaf":
        del tree["spatial_decoder"]["fc3"]["bias"]
    elif how == "wrong_shape":
        tree["grid4d"]["temporal"]["tables"] = np.zeros((2, 32, 2), np.float32)
    elif how == "untransposed_kernel":
        k = tree["fusion"]["layer_0"]["mlp"]["gate_proj"]["kernel"]
        tree["fusion"]["layer_0"]["mlp"]["gate_proj"]["kernel"] = k.T
    return tree


@pytest.mark.parametrize("how", ["leftover_leaf", "missing_leaf",
                                 "wrong_shape", "untransposed_kernel"])
def test_load_raises_and_copies_nothing(small, how):
    tree, cfg = small
    model = fresh(cfg)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError):
        load_flax_params(model, _broken(tree, how))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def _assert_same_fields(port, ref, path="cfg"):
    """Every field of the JAX config tree equals the port's, recursively."""
    if dataclasses.is_dataclass(ref):
        if type(port).__name__ != type(ref).__name__:
            # sections the port keeps as plain data
            assert port == json_plain(ref), path
            return
        for f in dataclasses.fields(ref):
            _assert_same_fields(getattr(port, f.name), getattr(ref, f.name),
                                f"{path}.{f.name}")
    elif isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_same_fields(port[k], ref[k], f"{path}[{k!r}]")
    elif ref in (jnp.float32, jnp.bfloat16, jnp.float16):
        assert port == getattr(torch, jnp.dtype(ref).name), path
    elif isinstance(ref, tuple):
        assert list(port) == list(ref), path
    else:
        assert port == ref, path


def json_plain(dc):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(dc).items()}


def test_config_from_json_rebuilds_the_astack_config():
    jax_cfg = bench.build_astack(batch_size=1)[0]
    port = config_from_json(jcfg.config_to_json(jax_cfg))
    _assert_same_fields(port, jax_cfg)
    assert port.grid4d.temporal.hash_table_size == 2 ** 17
    assert port.grid4d.temporal.base_resolution == 4
    assert port.fusion.universal_dim == 768


def test_config_from_json_reads_a_file(tmp_path):
    jax_cfg = jcfg.tiny_config()
    path = tmp_path / "config.json"
    jcfg.config_to_json(jax_cfg, str(path))
    _assert_same_fields(config_from_json(str(path)), jax_cfg)


@pytest.mark.parametrize("make", [
    lambda: bench.build_astack(batch_size=1)[0],
    jcfg.tiny_config,
    lambda: jcfg.DeepEarthConfig(
        optimizer=jcfg.OptimizerConfig(schedule="onecycle",
                                       second_moment="factored"),
        masking=jcfg.MaskingConfig(spatial_mask_prob=0.3)),
], ids=["astack", "tiny", "training_sections"])
def test_config_to_json_round_trips_through_jax(make):
    """The port writes the JAX package's schema: JAX reads it back to the
    config it started from."""
    jax_json = jcfg.config_to_json(make())
    port = config_from_json(jax_json)
    back = jcfg.config_from_json(config_to_json(port))
    # JAX's own round trip (it too turns tuples into lists)
    ref = jcfg.config_from_json(jax_json)
    for name in ("grid4d", "hidden_dim", "modalities", "modality_encoder",
                 "fusion", "masking", "optimizer", "param_dtype",
                 "compute_dtype"):
        assert getattr(back, name) == getattr(ref, name), name
    assert config_from_json(config_to_json(port)) == port


def test_chip_smoke_runs_the_bench_astack_config():
    """chip_smoke.py builds the model bench.build_astack defines."""
    sys.path.insert(0, REPO)
    import chip_smoke

    jax_cfg = bench.build_astack(batch_size=1)[0]
    ours = chip_smoke.astack_config()
    for name in ("grid4d", "hidden_dim", "n_heads", "n_layers", "modalities",
                 "modality_encoder", "fusion", "param_dtype",
                 "compute_dtype"):
        _assert_same_fields(getattr(ours, name), getattr(jax_cfg, name), name)


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'deepearth_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import deepearth_tpu_torch, deepearth_tpu_torch.kernels\n"
        "import deepearth_tpu_torch.ops, deepearth_tpu_torch.models\n"
        "import deepearth_tpu_torch.convert, deepearth_tpu_torch.training\n"
        "import deepearth_tpu_torch.ops.rope, deepearth_tpu_torch.ops.norms\n"
        "import deepearth_tpu_torch.ops.attention\n"
        "import deepearth_tpu_torch.ops.attention_vmem\n"
        "import deepearth_tpu_torch.ops.moe, deepearth_tpu_torch.ops.grouped_matmul\n"
        "import deepearth_tpu_torch.models.deepseek\n"
        "import deepearth_tpu_torch.models.encoders\n"
        "import deepearth_tpu_torch.ops.quant\n"
        "import deepearth_tpu_torch.models.mla_decode\n"
        "import deepearth_tpu_torch.models.generation\n"
        "import deepearth_tpu_torch.models.hf_convert\n"
        "import deepearth_tpu_torch.utils.logging\n"
        "import deepearth_tpu_torch.serving.language_server\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepearth_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_launch_counters_stay_zero_on_cpu(small):
    _, cfg = small
    kernels.reset_launch_counts()
    model = fresh(cfg)
    batch = {"xyzt": torch.rand(3, 4),
             "modalities": {"species": torch.tensor([1, 2, 3])}}
    with torch.inference_mode():
        model(batch)
        hash_encode(torch.rand(5, 3), torch.zeros(2, 64, 2),
                    torch.tensor([16.0, 32.0]))
        q = torch.randn(3, 2, 64)
        pairwise_token_attention(q, q, q, n_heads=4, scale=0.25)
        q = torch.randn(1, 2, 16, 32)
        k = torch.randn(1, 2, 300, 32)
        vmem_attention(q, k, k, scale=0.25)
        flash_attention.flash_attention(k, k, k, scale=0.25, causal=True)
        grouped_matmul.gmm(torch.randn(7, 8), torch.randn(3, 8, 5),
                           torch.tensor([2, 0, 5], dtype=torch.int32))
        x = torch.randn(2, 3, 256)
        quant.int8_bmm(x, *quant.quantize_int8(torch.randn(2, 256, 128)))
        quant.int4_bmm(x, *quant.quantize_int4(torch.randn(2, 256, 128)))
    from deepearth_tpu_torch.reconstruction import gaussian_splat as gs
    scene = gs.init_scene(torch.Generator().manual_seed(0), 20)
    cam = gs.Camera(torch.eye(3), torch.tensor([0.0, 0.0, 2.5]), 16.0, 16.0,
                    8.0, 8.0, 16, 16)
    for render in (gs.render, gs.render_tiled):
        leaves = [t.requires_grad_() for t in scene]
        render(gs.GaussianScene(*leaves), cam).sum().backward()
    grouped_matmul.gmm(torch.randn(7, 8, requires_grad=True),
                       torch.randn(3, 8, 5, requires_grad=True),
                       torch.tensor([2, 0, 5], dtype=torch.int32)
                       ).sum().backward()
    assert set(kernels.launch_counts.values()) == {0}
    assert set(kernels.launch_counts) == {
        "grid4d_encode_fwd", "hash_encode_fwd", "hash_encode_bwd",
        "hash_encode_bwd_scalar",
        "pairwise_attention_fwd", "pairwise_attention_fwd_warp",
        "pairwise_attention_bwd", "pairwise_attention_bwd_warp",
        "vmem_attention_fwd",
        "vmem_attention_fwd_mma", "vmem_attention_fwd_fp32",
        "vmem_attention_bwd", "vmem_attention_bwd_mma",
        "vmem_attention_bwd_fp32",
        "flash_attention_fwd", "flash_attention_fwd_mma",
        "flash_attention_fwd_fp32", "flash_attention_bwd",
        "flash_attention_bwd_mma", "flash_attention_bwd_fp32",
        "grouped_matmul_fwd", "grouped_matmul_fwd_mma",
        "grouped_matmul_fwd_fp32", "grouped_matmul_split_dout", "grouped_matmul_bwd_dlhs",
        "grouped_matmul_bwd_dlhs_mma", "grouped_matmul_bwd_dlhs_fp32",
        "grouped_matmul_bwd_drhs", "grouped_matmul_bwd_drhs_mma",
        "grouped_matmul_bwd_drhs_fp32", "int8_bmm", "int8_bmm_fma",
        "int4_bmm", "int4_bmm_fma", "splat_bin", "splat_composite_fwd",
        "splat_composite_bwd"}
