"""The rest of ``models/`` against the JAX package, on the CPU: the A-stack
blocks (``MultiHeadAttention`` under both RoPE variants with a key mask,
``TransformerBlock``, ``Transformer``, ``ModalityEncoder``),
``HierarchicalFusion`` at an odd token count, ``InductiveSimulator`` with a
``token_mask`` (and with remat), ``create_inductive_simulator``,
``MaskingStrategy`` and ``DatasetSpecificDecoder`` (the C-stack's modules:
tests/test_torch_cstack.py).

Small widths; parameters come from the JAX module's ``init`` through
``load_flax_params``, inputs are numpy arrays from a seed, fp32, eval mode
(JAX's ``deterministic=True``). Tolerance: 1e-5 of each output's largest
entry, as tests/test_torch_simulator.py states it for modules.
``MaskingStrategy`` draws from a ``torch.Generator`` where JAX takes a key,
so its masks are held on their shape, structure, rate and repeatability
instead, and its errors on JAX's text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import encoders as jenc
from deepearth_tpu.models import fusion as jfusion
from deepearth_tpu.models import simulator as jsim
from deepearth_tpu.models import transformer as jtr
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import flax_params_from_model, load_flax_params
from deepearth_tpu_torch.models import (
    DatasetSpecificDecoder,
    HierarchicalFusion,
    InductiveSimulator,
    MaskingStrategy,
    ModalityEncoder,
    MultiHeadAttention,
    Transformer,
    TransformerBlock,
    create_inductive_simulator,
)
from deepearth_tpu_torch.models.layers import Conv1d, Init

torch.set_num_threads(2)

REL = 1e-5
B = 3


def features(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def init(seed=0):
    return Init(torch.Generator().manual_seed(seed), "cpu")


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(np.asarray(tree))


def close(out, ref, rel=REL):
    """out (a tensor or a dict / list of them) within rel of each ref
    output's largest entry."""
    if isinstance(ref, dict):
        assert set(out) == set(ref)
        for k in ref:
            close(out[k], ref[k], rel)
        return
    if isinstance(ref, (list, tuple)):
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            close(a, b, rel)
        return
    ref = np.asarray(ref, np.float32)
    got = out.detach().float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max() + 1e-12)


def paired(jmod, tmod, *args, **kwargs):
    """JAX's init on the inputs, its params loaded into the port module;
    both outputs (the port in eval mode, without grad)."""
    jargs = [to_jax(a) for a in args]
    jkw = {k: to_jax(v) for k, v in kwargs.items()}
    params = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a,
                                          **jkw))(*jargs)["params"]
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **jkw))(
        params, *jargs)
    tmod.eval()
    with torch.no_grad():
        out = tmod(*[to_torch(a) for a in args],
                   **{k: to_torch(v) for k, v in kwargs.items()})
    return out, ref, params


def tcfg_pair(**kw):
    return jcfg.TransformerConfig(**kw), tcfg.TransformerConfig(**kw)


def key_mask(n):
    """(B, n): row 0 all visible, row 1 ragged, row 2 all masked (its
    attention outputs zeros on both sides)."""
    m = np.ones((B, n), bool)
    m[1, n // 2:] = False
    m[2] = False
    return m


@pytest.mark.parametrize("variant", ["interleaved", "half"])
def test_multi_head_attention_matches_jax(variant):
    jc, tc = tcfg_pair(hidden_dim=32, n_heads=4, n_layers=1,
                       rope_variant=variant)
    x = features(1, B, 9, 32)
    out, ref, _ = paired(jtr.MultiHeadAttention(jc),
                         MultiHeadAttention(tc, init(), torch.float32), x,
                         key_mask(9))
    close(out, ref)


def test_rope_variants_differ():
    """Guard: the two variants rotate different pairs of q's entries."""
    outs = []
    for variant in ("interleaved", "half"):
        _, tc = tcfg_pair(hidden_dim=32, n_heads=4, rope_variant=variant)
        mod = MultiHeadAttention(tc, init(), torch.float32).eval()
        with torch.no_grad():
            outs.append(mod(torch.from_numpy(features(2, B, 9, 32))))
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("gated", [False, True])
def test_transformer_block_and_stack_match_jax(gated):
    jc, tc = tcfg_pair(hidden_dim=32, n_heads=4, n_layers=2,
                       use_gated_mlp=gated)
    x, mask = features(3, B, 7, 32), key_mask(7)
    out, ref, _ = paired(jtr.TransformerBlock(jc),
                         TransformerBlock(tc, init(), torch.float32), x, mask)
    close(out, ref)
    out, ref, params = paired(jtr.Transformer(jc),
                              Transformer(tc, init(), torch.float32), x, mask)
    close(out, ref)
    assert set(params) == {"block_0", "block_1", "final_norm"}


def test_modality_encoder_matches_jax():
    """Norm eps 1e-5 where the config says 1e-6: the last LayerNorm is
    torch's default in both."""
    jc, tc = tcfg_pair(hidden_dim=32, n_heads=4, n_layers=2)
    mask = np.array([True, False, True])
    out, ref, _ = paired(jenc.ModalityEncoder(10, 24, jc),
                         ModalityEncoder(10, 24, tc, init(), torch.float32),
                         features(4, B, 10), mask)
    close(out, ref)
    mod = ModalityEncoder(10, 24, tc, init(), torch.float32)
    assert mod.norm.eps == 1e-5 and mod.transformer.block_0.norm1.eps == 1e-6


def fusion_pair():
    kw = dict(universal_dim=32, num_fusion_layers=2, num_heads=4)
    return jcfg.FusionConfig(**kw), tcfg.FusionConfig(**kw)


@pytest.mark.parametrize("n_vision", [7, 8])
def test_hierarchical_fusion_matches_jax(n_vision):
    """7 vision tokens: flax's 'SAME' padding pads one zero row at the end,
    giving ceil(7 / 2) = 4 tokens as [:, ::2] gives 4 positions. Level 0
    runs batch-major (9 or 10 tokens), levels 1 and 2 token-major."""
    jc, tc = fusion_pair()
    names = ("spacetime", "vision")
    tokens = {"spacetime": features(5, B, 1, 32),
              "vision": features(6, B, n_vision, 32)}
    rng = np.random.default_rng(7)
    spatial = {"vision": rng.uniform(size=(B, n_vision, 2)).astype(
        np.float32)}
    temporal = {n: rng.uniform(size=(B, t.shape[1], 1)).astype(np.float32)
                for n, t in tokens.items()}
    out, ref, params = paired(
        jfusion.HierarchicalFusion(jc, names),
        HierarchicalFusion(tc, names, init(), torch.float32, spatial=True),
        tokens, spatial, temporal)
    close(out, ref)
    assert params["down_0_vision"]["kernel"].shape == (2, 32, 32)
    assert set(params) == {"level_0", "level_1", "level_2", "final_fusion",
                           *(f"down_{lv}_{n}" for lv in (0, 1)
                             for n in names)}


def test_conv_same_padding_and_layout():
    """The port's Conv1d against flax's nn.Conv at odd and even lengths,
    kernel 2 and 3, stride 2 (flax pads (k - 1 + (n-1) mod s) zeros, the
    smaller half first); and the converter's round trip of its kernel."""
    from flax import linen as nn
    for n, k in ((7, 2), (8, 2), (7, 3), (5, 3)):
        x = features(8, B, n, 6)
        out, ref, params = paired(
            nn.Conv(4, kernel_size=(k,), strides=(2,)),
            Conv1d(6, 4, k, 2, init(), torch.float32), x)
        close(out, ref)
        assert out.shape[1] == -(-n // 2)
    mod = Conv1d(6, 4, 3, 2, init(), torch.float32)
    tree = flax_params_from_model(mod)
    assert tree["kernel"].shape == (3, 6, 4)
    np.testing.assert_array_equal(tree["kernel"],
                                  mod.weight.detach().numpy().T)


def sim_pair():
    kw = dict(hidden_dim=32, n_heads=4, kv_lora_rank=16, qk_rope_head_dim=8,
              qk_nope_head_dim=16, v_head_dim=12)
    moe = dict(n_routed_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=24, hidden_dim=32)
    return tuple(c.DeepSeekBlockConfig(hidden_dim=32, n_layers=2,
                                       intermediate_size=48,
                                       mla=c.MLAConfig(**kw),
                                       moe=c.MoEConfig(**moe))
                 for c in (jcfg, tcfg))


@pytest.mark.parametrize("remat", [False, True])
def test_inductive_simulator_with_token_mask_matches_jax(remat):
    jc, tc = sim_pair()
    x = features(9, B, 10, 32)
    mask = np.random.default_rng(10).uniform(size=(B, 10)) > 0.3
    out, ref, params = paired(
        jsim.InductiveSimulator(jc),
        InductiveSimulator(tc, init(), torch.float32, remat=remat,
                           remat_policy="dots"), x, token_mask=mask)
    close(out, ref)
    assert set(params) == {"mask_token", "transformer"}
    # without a mask: the tokens as given, no mask token in JAX's tree
    out, ref, params = paired(
        jsim.InductiveSimulator(jc),
        InductiveSimulator(tc, init(), torch.float32, mask_token=False), x)
    close(out, ref)
    assert set(params) == {"transformer"}


def test_create_inductive_simulator_presets():
    jmod, jc = jsim.create_inductive_simulator("fast", n_layers=2)
    mod, tc = create_inductive_simulator(
        "fast", generator=torch.Generator().manual_seed(0), device="cpu",
        n_layers=2)
    assert jcfg.config_to_json(jcfg.DeepEarthConfig(
        fusion=jcfg.FusionConfig(deepseek_block=jc))) == tcfg.config_to_json(
        tcfg.DeepEarthConfig(fusion=tcfg.FusionConfig(deepseek_block=tc)))
    assert isinstance(mod, InductiveSimulator) and mod.cfg is tc
    assert mod.transformer.n_layers == 2
    assert tc.hidden_dim == 1024 and tc.moe.n_routed_experts == 4
    with pytest.raises(KeyError):
        create_inductive_simulator("huge", generator=torch.Generator(),
                                   device="cpu")


def test_dataset_specific_decoder_matches_jax():
    dims = {"soil": 3, "birds": 5}
    out, ref, _ = paired(jsim.DatasetSpecificDecoder(dims),
                         DatasetSpecificDecoder(dims, 16, init(),
                                                torch.float32),
                         features(11, B, 16))
    close(out, ref)
    assert list(out) == ["birds", "soil"]


def test_masking_strategy_shapes_and_structure():
    g = torch.Generator().manual_seed(0)
    ms = MaskingStrategy(mask_ratio=0.25, grid=(4, 6))
    rnd = ms.random(g, 64, 24)
    assert rnd.shape == (64, 24) and rnd.dtype == torch.bool
    assert 0.6 < rnd.float().mean().item() < 0.9
    blk = ms.block(g, 16, 24)
    hidden = ~blk
    assert (hidden.sum(dim=1) == 6).all()  # round(24 * 0.25)
    for row in hidden:  # one contiguous run
        idx = row.nonzero().flatten()
        assert (idx.diff() == 1).all()
    tmp = ms.temporal(g, 8, 24).view(8, 4, 6)
    assert (tmp == tmp[:, :, :1]).all()  # a whole time slice together
    sp = ms.spatial(g, 8, 24).view(8, 4, 6)
    assert (sp == sp[:, :1, :]).all()  # a position at every time
    # the draws repeat under one seed
    a = MaskingStrategy(0.5).random(torch.Generator().manual_seed(7), 4, 9)
    b = MaskingStrategy(0.5).random(torch.Generator().manual_seed(7), 4, 9)
    assert torch.equal(a, b)
    assert MaskingStrategy(0.0).block(g, 2, 10).sum() == 18  # at least 1


def test_masking_strategy_errors_are_jax_errors():
    cases = [(MaskingStrategy(0.2), 12), (MaskingStrategy(0.2, (3, 5)), 12)]
    for (tm, n), (jm, _) in zip(cases, [(jsim.MaskingStrategy(0.2), 12),
                                        (jsim.MaskingStrategy(0.2, (3, 5)),
                                         12)]):
        with pytest.raises(ValueError) as jerr:
            jm.temporal(jax.random.PRNGKey(0), 2, n)
        with pytest.raises(ValueError) as terr:
            tm.temporal(torch.Generator(), 2, n)
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError):
            tm.spatial(torch.Generator(), 2, n)
