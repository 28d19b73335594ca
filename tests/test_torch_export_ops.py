"""The forward kernels as ``torch.ops.deepearth`` operators, on the CPU.

Under an export trace (``torch.compiler.is_exporting()`` patched to True,
fake CUDA tensors) each of the eight forward dispatchers that gained an
operator (K2-fwd per table, K3-fwd, K4-fwd, K5-fwd, K6, K7, K8, K9-fwd)
calls it: ``make_fx`` records the operator, its fake gives the shapes and
dtypes the plain version gives on real CPU tensors of the same shapes
(each route's shape class: K3 and K4 at 48/32 and 128/128, K4 at 192/128
and 256/256, K5 with an empty group, K6 and K7 at E=1 and E=16, K8 at
G = 2,000, K9 tiled and dense), and no launch counter moves. The backward
kernels are not operators: their launch under the trace raises
``ValueError``. On the CPU a program runs the plain versions; the exported
tiny multimodal model (K3's plain path) and ``render_tiled`` are held
against the JAX package's exported programs within 1e-5 (fp32, the same
arithmetic summed in another order). The exported programs on the card are
held by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 24.
"""

import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from deepearth_tpu import configs as jcfg
from deepearth_tpu import export as jexport
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.reconstruction import gaussian_splat as jgs
from deepearth_tpu_torch import export as texport
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import config_from_json
from deepearth_tpu_torch.convert import (camera_from_jax,
                                         gaussian_scene_from_jax,
                                         load_flax_params)
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.ops import (attention_vmem, flash_attention,
                                     grouped_matmul, hash_encoding, quant,
                                     splat)
from deepearth_tpu_torch.reconstruction import gaussian_splat as tgs

torch.set_num_threads(2)

BF16, F32, I8, I32 = torch.bfloat16, torch.float32, torch.int8, torch.int32


def _real(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.3
    if dtype in (I8, I32):
        return torch.randint(-8, 8, shape, generator=gen, dtype=dtype)
    return torch.randn(shape, generator=gen).to(dtype)


def _attn(b, h, n, dqk, dv):
    return [((b, h, n, dqk), BF16), ((b, h, n, dqk), BF16),
            ((b, h, n, dv), BF16)]


# name -> (operator, [(shape, dtype) of each tensor argument], the
# dispatcher over those tensors, the plain version over them)
CASES = {
    "k2_per_table": (
        "hash_encode_fwd", [((50, 3), F32), ((4, 64, 2), F32), ((4,), F32)],
        lambda c, t, r: kernels.hash_encode_fwd(c, t, r, 64, True),
        lambda c, t, r: hash_encoding.hash_encode_plain(
            c, t, r, interpolation="linear", table_size=64)),
    **{f"k3_{dqk}_{dv}": (
        "vmem_attention_fwd", _attn(2, 2, 40, dqk, dv),
        lambda q, k, v: kernels.vmem_attention_fwd(q, k, v, 0.125),
        lambda q, k, v: attention_vmem.vmem_attention_plain(q, k, v,
                                                            scale=0.125))
       for dqk, dv in ((48, 32), (128, 128))},
    **{f"k4_{dqk}_{dv}": (
        "flash_attention_fwd", _attn(1, 2, 24, dqk, dv),
        lambda q, k, v: kernels.flash_attention_fwd(q, k, v, 0.1, None,
                                                    True),
        lambda q, k, v: flash_attention.flash_attention_plain(
            q, k, v, scale=0.1, causal=True, return_lse=True))
       for dqk, dv in ((48, 32), (128, 128), (192, 128), (256, 256))},
    "k5_empty_group": (
        "grouped_matmul_fwd",
        [((10, 16), BF16), ((3, 16, 24), BF16), ((3,), I32)],
        kernels.grouped_matmul_fwd,
        lambda lhs, rhs, sizes: grouped_matmul.gmm_plain(
            lhs, rhs, torch.tensor([4, 0, 6], dtype=I32))),
    **{f"k6_e{e}": (
        "int8_bmm", [((e, c, 256), BF16), ((e, 256, fp), I8),
                     ((e, 1, f), F32)],
        lambda x, w, s: kernels.int8_bmm(x, w, s, BF16),
        lambda x, w, s: quant.int8_bmm_plain(x, w, s, BF16))
       for e, c, fp, f in ((1, 8, 384, 384), (16, 4, 128, 120))},
    **{f"k7_e{e}": (
        "int4_bmm", [((e, c, 256), BF16), ((e, 128, fp), I8),
                     ((e, 1, f), F32)],
        lambda x, w, s: kernels.int4_bmm(x, w, s, F32),
        lambda x, w, s: quant.int4_bmm_plain(x, w, s, F32))
       for e, c, fp, f in ((1, 8, 384, 384), (16, 4, 128, 120))},
    "k8_g2000": (
        "splat_bin", [((2000, 2), F32), ((2000,), F32),
                      ((2000,), torch.bool)],
        lambda xy, r, valid: kernels.splat_bin(xy, r, valid, 16, 16, 16,
                                               512),
        lambda xy, r, valid: splat.bin_tiles_plain(xy * 100.0, r.abs(),
                                                   valid, 16, 16, 16, 512)),
    "k9_tiled": (
        "splat_composite_fwd",
        [((16, 64, 2), F32), ((16, 64, 3), F32), ((16, 64), F32),
         ((16, 64, 3), F32), ((3,), F32)],
        lambda *t: kernels.splat_composite_fwd(*t, 64, 64, 16, 16),
        lambda *t: splat.composite_plain(*t, 64, 64, 16, 16)),
    "k9_dense": (
        "splat_composite_fwd",
        [((1, 100, 2), F32), ((1, 100, 3), F32), ((1, 100), F32),
         ((1, 100, 3), F32)],
        lambda *t: kernels.splat_composite_fwd(*t, None, 32, 48, 32, 48),
        lambda *t: splat.composite_plain(*t, None, 32, 48, 32, 48)),
}


def _fake_export_mode():
    return mock.patch.object(torch.compiler, "is_exporting", lambda: True)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatcher_calls_its_operator_with_the_plain_shapes(case):
    op, specs, dispatch, plain = CASES[case]
    want = _as_tuple(plain(*(_real(s, d, i) for i, (s, d) in
                             enumerate(specs))))
    kernels.reset_launch_counts()
    with FakeTensorMode(), _fake_export_mode():
        args = [torch.empty(s, dtype=d, device="cuda") for s, d in specs]
        got = _as_tuple(dispatch(*args))
        graph = make_fx(dispatch)(*args).graph
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "cuda" for t in got)
    targets = {n.target for n in graph.nodes if n.op == "call_function"}
    assert getattr(torch.ops.deepearth, op).default in targets
    assert set(kernels.launch_counts.values()) == {0}


def test_every_forward_kernel_has_an_operator():
    names = {"pairwise_attention_fwd", "grid4d_encode_fwd", "hash_encode_fwd",
             "vmem_attention_fwd", "flash_attention_fwd",
             "grouped_matmul_fwd", "int8_bmm", "int4_bmm", "splat_bin",
             "splat_composite_fwd"}
    assert all(hasattr(torch.ops.deepearth, n) for n in names)
    assert {c[0] for c in CASES.values()} == names - {
        "pairwise_attention_fwd", "grid4d_encode_fwd"}
    assert not hasattr(kernels, "EXPORT_TODO")


def _backward_calls():
    q = torch.empty((1, 2, 16, 64), dtype=BF16, device="cuda")
    lse = torch.empty((1, 2, 16), device="cuda")
    tok = torch.empty((3, 4, 64), dtype=BF16, device="cuda")
    coords = torch.empty((5, 3), device="cuda")
    res = torch.empty((2,), device="cuda")
    lhs = torch.empty((8, 16), dtype=BF16, device="cuda")
    rhs = torch.empty((2, 16, 24), dtype=BF16, device="cuda")
    sizes = torch.empty((2,), dtype=I32, device="cuda")
    lists = [torch.empty(s, device="cuda") for s in
             ((1, 8, 2), (1, 8, 3), (1, 8), (1, 8, 3))]
    return {
        "pairwise_attention_bwd": lambda: kernels.pairwise_attention_bwd(
            tok, tok, tok, tok, 4, 0.125),
        "hash_encode_bwd": lambda: kernels.hash_encode_bwd(
            coords, torch.empty((5, 4), device="cuda"), res, (2, 64, 2), 64,
            True),
        "vmem_attention_bwd": lambda: kernels.vmem_attention_bwd(
            q, q, q, q, 0.125),
        "flash_attention_bwd": lambda: kernels.flash_attention_bwd(
            q, q, q, q, lse, q, 0.125),
        "grouped_matmul_split_dout": lambda: kernels.grouped_matmul_split_dout(
            torch.empty((8, 24), device="cuda")),
        "grouped_matmul_bwd": lambda: kernels.grouped_matmul_bwd(
            lhs, rhs, sizes, torch.empty((8, 24), device="cuda")),
        "splat_composite_fwd_keep_state": lambda: kernels.splat_composite_fwd(
            *lists, None, 16, 16, 16, 16, keep_state=True),
        "splat_composite_bwd": lambda: kernels.splat_composite_bwd(
            *lists, None, torch.empty((1, 1, 5, 256), device="cuda"),
            torch.empty((16, 16, 3), device="cuda"), 16, 16, 16, 16),
        "vmem_attention_fwd_tma": lambda: kernels.vmem_attention_fwd_tma(
            q, q, q, 0.125),
    }


OUTSIDE = ["pairwise_attention_bwd", "hash_encode_bwd", "vmem_attention_bwd",
           "flash_attention_bwd", "grouped_matmul_split_dout",
           "grouped_matmul_bwd", "splat_composite_fwd_keep_state",
           "splat_composite_bwd", "vmem_attention_fwd_tma"]


@pytest.mark.parametrize("name", OUTSIDE)
def test_a_launch_outside_the_operators_raises(name):
    """The backward kernels (and a route's own entry, which the operators
    never reach under a trace) raise ValueError: an exported program is
    an inference program."""
    kernels.reset_launch_counts()
    with FakeTensorMode(), _fake_export_mode():
        with pytest.raises(ValueError, match="inference program"):
            _backward_calls()[name]()
    assert set(kernels.launch_counts.values()) == {0}


# -- CPU exports against the JAX package's ---------------------------------- #


def test_exported_multimodal_model_matches_jax():
    """A tiny multimodal model exported with export_forward, reloaded,
    against the eager port bit for bit and JAX's exported program within
    1e-5: vision over 288 patches, so that the encoder's MLA is a K3 site
    on the card (256 to 1024 keys); on the CPU the attention runs its plain
    path."""
    cfg = jcfg.DeepEarthConfig(
        hidden_dim=64, n_heads=4, n_layers=2,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                 hash_table_size=2 ** 10),
        modality_encoder=jcfg.TransformerConfig(hidden_dim=32, n_heads=4,
                                                n_layers=1),
        compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=232))
    cfg.add_modality(jcfg.ModalityConfig(name="vision", input_dim=48,
                                         n_tokens=4, encoder_layers=1,
                                         encoder_heads=4))
    rng = np.random.default_rng(0)
    batch = {"xyzt": rng.uniform(0, 1, (3, 4)).astype(np.float32),
             "modalities": {
                 "species": rng.integers(0, 232, 3).astype(np.int32),
                 "vision": rng.normal(size=(3, 288, 48)).astype(np.float32)}}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jmodel = JaxModel(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jbatch)["params"]
    jfused, jrecon = jexport.load_exported(
        jexport.export_forward(jmodel, params, jbatch))(params, jbatch)
    model = DeepEarthModel(config_from_json(jcfg.config_to_json(cfg)),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens={"vision": 288})
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    tbatch = {"xyzt": torch.from_numpy(batch["xyzt"]), "modalities": {
        k: torch.from_numpy(v) for k, v in batch["modalities"].items()}}
    tparams = {k: v.detach() for k, v in model.named_parameters()}
    fn = texport.load_exported(texport.export_forward(model, tparams,
                                                      tbatch))
    fused, recon = fn(tparams, tbatch)
    with torch.no_grad():
        ref = model.eval()(tbatch)
    assert torch.equal(fused, ref["fused_representation"])
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), rtol=0,
                               atol=1e-5)
    assert recon.keys() == ref["reconstructions"].keys() == jrecon.keys()
    for k in recon:
        assert torch.equal(recon[k], ref["reconstructions"][k]), k
        np.testing.assert_allclose(recon[k].numpy(), np.asarray(jrecon[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_exported_render_tiled_matches_jax():
    """render_tiled (K8's and K9-fwd's plain versions) exported with
    export_fn over the scene's five tensors, reloaded: the eager port's
    image bit for bit and JAX's exported render_tiled within 1e-5 of the
    largest entry, on a 32 x 32 image of 200 Gaussians in front of the
    camera with 48 a tile at most."""
    rng = np.random.default_rng(3)
    g = 200
    scene = jgs.GaussianScene(
        means=jnp.asarray(rng.uniform(-1, 1, (g, 3)), jnp.float32),
        log_scales=jnp.asarray(np.log(0.08) + 0.3 * rng.normal(size=(g, 3)),
                               jnp.float32),
        quats=jnp.asarray(rng.normal(size=(g, 4)), jnp.float32),
        colors=jnp.asarray(rng.normal(size=(g, 3)), jnp.float32),
        opacity_logits=jnp.asarray(rng.normal(0.5, 1.5, g), jnp.float32))
    cam = jgs.Camera(rotation=jnp.eye(3),
                     translation=jnp.asarray([0.0, 0.0, 2.0]), fx=32.0,
                     fy=32.0, cx=16.0, cy=16.0, width=32, height=32)
    want = jexport.load_exported(jexport.export_fn(
        lambda *f: jgs.render_tiled(jgs.GaussianScene(*f), cam,
                                    max_per_tile=48), *scene))(*scene)
    tscene, tcam = gaussian_scene_from_jax(scene), camera_from_jax(cam)

    def render(*fields):
        return tgs.render_tiled(tgs.GaussianScene(*fields), tcam,
                                max_per_tile=48)
    fn = texport.load_exported(texport.export_fn(render, *tscene))
    got = fn(*tscene)
    with torch.no_grad():
        assert torch.equal(got, render(*tscene))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
