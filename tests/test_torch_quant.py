"""The port's weight-only quantization (``ops/quant.py``) against the JAX
package's, on the CPU.

Quantization is the same fp32 arithmetic (absmax, max(absmax, 1e-12) / 127
or / 7, round half to even, clip), so bytes and scales must be bit for bit
JAX's eager ones. (Under ``jax.jit`` XLA rewrites the division by 127 as a
multiplication by its reciprocal, so a jitted JAX scale may differ from its
own eager one in the last bit; the bytes do not.)

``int8_bmm_plain`` / ``int4_bmm_plain`` are held against JAX's Pallas
kernels run in interpret mode, as ``tests/test_quant.py`` runs them on the
CPU: both multiply bf16-rounded x by weights exact in bf16, so every
product is exact in fp32 and only the order of the fp32 sums differs: 1e-5
of the largest entry in fp32 outputs, one bf16 ulp of the largest entry in
bf16 outputs. At the shapes where JAX leaves its kernel for an einsum in
x's type (D not a multiple of 128; an odd packed D), the port takes the same
einsum: the same tolerances.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepSeekForCausalLM as JaxLM
from deepearth_tpu.ops import quant as jq
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import flax_params_from_model, load_flax_params
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.models import DeepSeekForCausalLM
from deepearth_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

REL = 1e-5


def rng(seed):
    return np.random.default_rng(seed)


def weights(seed, *shape):
    """Columns of different magnitudes, so every scale differs."""
    r = rng(seed)
    return (r.standard_normal(shape)
            * r.uniform(0.05, 3.0, size=shape[-1])).astype(np.float32)


def bf16_ulp(x) -> float:
    top = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def close(out: torch.Tensor, ref, dtype):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    tol = REL * np.abs(ref).max() if dtype == torch.float32 else bf16_ulp(ref)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


# --------------------------------------------------------------------------- #
# quantization, bit for bit
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(256, 576), (512, 96), (3, 512, 200),
                                   (2, 256, 130)],
                         ids=["2d F576", "2d F96", "3d F200", "3d F130"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_is_bit_identical_to_jax(shape, bits):
    w = weights(0, *shape)
    fn = "quantize_int8" if bits == 8 else "quantize_int4"
    q_ref, s_ref = (np.asarray(a) for a in getattr(jq, fn)(jnp.asarray(w)))
    q, s = getattr(tq, fn)(torch.tensor(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == q_ref.shape and s.shape == s_ref.shape
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    deq = tq.dequantize(q, s) if bits == 8 else tq.dequantize_int4(q, s)
    ref = (jq.dequantize(q_ref, s_ref) if bits == 8
           else jq.dequantize_int4(jnp.asarray(q_ref), s_ref))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref))


def test_quantize_bf16_weights_and_odd_int4_rows():
    w = weights(1, 256, 300)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    q_ref, s_ref = jq.quantize_int8(wb)
    q, s = tq.quantize_int8(torch.tensor(w).to(torch.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    with pytest.raises(ValueError, match="even reduction dim"):
        tq.quantize_int4(torch.zeros(5, 8))


# --------------------------------------------------------------------------- #
# the plain versions of K6 / K7 against the interpreted Pallas kernels
# --------------------------------------------------------------------------- #

BMM_CASES = [(1, 1, 256, 576), (1, 5, 256, 300), (4, 32, 256, 130),
             (4, 5, 512, 256), (4, 1, 256, 200)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _bmm_inputs(seed, e, c, d, f):
    x = rng(seed).standard_normal((e, c, d)).astype(np.float32)
    return x, weights(seed + 1, e, d, f)


@pytest.mark.parametrize("case", BMM_CASES,
                         ids=[f"E{e} C{c} D{d} F{f}" for e, c, d, f in
                              BMM_CASES])
@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_bmm_plain_matches_the_interpreted_kernel(case, dt, bits):
    jdt, tdt = dt
    x, w = _bmm_inputs(2, *case)
    quant, bmm, plain = ((jq.quantize_int8, jq.int8_bmm, tq.int8_bmm_plain)
                         if bits == 8 else
                         (jq.quantize_int4, jq.int4_bmm, tq.int4_bmm_plain))
    q, s = quant(jnp.asarray(w))
    ref = bmm(jnp.asarray(x).astype(jdt), q, s, out_dtype=jdt,
              interpret=True).astype(jnp.float32)
    args = (torch.tensor(x).to(tdt), torch.tensor(np.asarray(q)),
            torch.tensor(np.asarray(s)))
    out = plain(*args, out_dtype=tdt)
    assert out.dtype == tdt
    close(out, ref, tdt)
    # the dispatch takes the plain version for CPU tensors
    dispatch = tq.int8_bmm if bits == 8 else tq.int4_bmm
    assert torch.equal(dispatch(*args, out_dtype=tdt), out)


@pytest.mark.parametrize("bits,d", [(8, 200), (4, 202), (4, 384)],
                         ids=["int8 D200", "int4 D/2 odd", "int4 D/2 192"])
@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
def test_einsum_route_shapes_match_jax(bits, d, dt):
    jdt, tdt = dt
    x, w = _bmm_inputs(3, 2, 5, d, 140)
    quant, bmm, tbmm = ((jq.quantize_int8, jq.int8_bmm, tq.int8_bmm)
                        if bits == 8 else
                        (jq.quantize_int4, jq.int4_bmm, tq.int4_bmm))
    q, s = quant(jnp.asarray(w))
    ref = bmm(jnp.asarray(x).astype(jdt), q, s, out_dtype=jdt,
              interpret=True).astype(jnp.float32)
    out = tbmm(torch.tensor(x).to(tdt), torch.tensor(np.asarray(q)),
               torch.tensor(np.asarray(s)), out_dtype=tdt)
    close(out, ref, tdt)


@pytest.mark.parametrize("rows,fp,c,int4,want", [
    (256, 640, 8, False, True), (200, 256, 8, False, False),
    (256, 200, 8, False, False), (256, 256, 10592, False, True),
    (256, 256, 10593, False, False), (128, 256, 7552, True, True),
    (128, 256, 7553, True, False), (101, 256, 4, True, False)])
def test_kernel_route_follows_jax_pick_tiles(rows, fp, c, int4, want):
    cp = max(-(-c // 16) * 16, 16)
    bd, bf = jq._pick_tiles(rows, fp, cp, int4=int4)
    assert (bd is not None and bf is not None) == want
    assert tq._tiles_fit(rows, fp, c, int4) == want


def test_matmul_leading_dims_and_linear_p():
    x = rng(4).standard_normal((2, 3, 256)).astype(np.float32)
    w = weights(5, 256, 96)
    for quant, jmm, tmm in ((jq.quantize_int8, jq.int8_matmul,
                             tq.int8_matmul),
                            (jq.quantize_int4, jq.int4_matmul,
                             tq.int4_matmul)):
        q, s = quant(jnp.asarray(w))
        ref = jmm(jnp.asarray(x), q, s, out_dtype=jnp.float32,
                  interpret=True)
        out = tmm(torch.tensor(x), torch.tensor(np.asarray(q)),
                  torch.tensor(np.asarray(s)), out_dtype=torch.float32)
        assert out.shape == (2, 3, 96)
        close(out, ref, torch.float32)
    # linear_p: a quantized Dense with its bias, and a plain one
    b = rng(6).standard_normal(96).astype(np.float32)
    q, s = jq.quantize_int4(jnp.asarray(w))
    ref = jq.linear_p({"kernel_q4": q, "scale": s, "bias": jnp.asarray(b)},
                      jnp.asarray(x))
    layer = tq.QuantDense(torch.tensor(np.asarray(q)),
                          torch.tensor(np.asarray(s)),
                          torch.nn.Parameter(torch.tensor(b)), int4=True)
    close(layer(torch.tensor(x)), ref, torch.float32)
    plain = torch.nn.Linear(256, 96)
    with torch.no_grad():
        plain.weight.copy_(torch.tensor(w.T))
        plain.bias.copy_(torch.tensor(b))
    ref = jq.linear_p({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                      jnp.asarray(x))
    close(tq.linear_p(plain, torch.tensor(x)), ref, torch.float32)


def test_expert_ffn_q_matches_jax():
    e, c, d, f = 4, 6, 256, 256
    r = rng(6)
    x = r.standard_normal((e, c, d)).astype(np.float32)
    jp, layer = {}, torch.nn.Module()
    for i, (k, shape, quant, tag) in enumerate((
            ("w_gate", (e, d, f), jq.quantize_int4, "_q4"),
            ("w_up", (e, d, f), jq.quantize_int8, "_q"),
            ("w_down", (e, f, d), jq.quantize_int4, "_q4"))):
        q, s = quant(jnp.asarray(weights(7 + i, *shape) * 0.1))
        jp[k + tag], jp[k + "_scale"] = q, s
        setattr(layer, k + tag, torch.nn.Parameter(
            torch.tensor(np.asarray(q)), requires_grad=False))
        setattr(layer, k + "_scale", torch.nn.Parameter(
            torch.tensor(np.asarray(s)), requires_grad=False))
    ref = jq.expert_ffn_q(jp, jnp.asarray(x))
    out = tq.expert_ffn_q(layer, torch.tensor(x))
    close(out, ref, torch.float32)


def test_wrappers_run_no_kernel_on_the_cpu():
    kernels.reset_launch_counts()
    x = torch.randn(2, 3, 256)
    q, s = tq.quantize_int8(torch.randn(2, 256, 128))
    tq.int8_bmm(x, q, s)
    q4, s4 = tq.quantize_int4(torch.randn(2, 256, 128))
    tq.int4_bmm(x, q4, s4)
    assert kernels.launch_counts["int8_bmm"] == 0
    assert kernels.launch_counts["int4_bmm"] == 0


# --------------------------------------------------------------------------- #
# the converter over a model, and the trees it makes
# --------------------------------------------------------------------------- #

def lm_cfg(mod):
    """hidden 256, so that the int4 converter keeps 256-row reductions and
    falls back to int8 on 128-row ones (o_proj, the experts' w_down)."""
    return mod.DeepSeekBlockConfig(
        hidden_dim=256, n_layers=3, intermediate_size=512,
        mla=mod.MLAConfig(hidden_dim=256, n_heads=4, kv_lora_rank=128,
                          qk_rope_head_dim=32, qk_nope_head_dim=32,
                          v_head_dim=32),
        moe=mod.MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                          moe_intermediate_size=128, hidden_dim=256,
                          n_shared_experts=1),
        first_k_dense_replace=1)


VOCAB = 512


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def lm_pair(request):
    tie = request.param
    jm = JaxLM(lm_cfg(jcfg), vocab_size=VOCAB, tie_embeddings=tie)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = DeepSeekForCausalLM(lm_cfg(tcfg), VOCAB,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu", tie_embeddings=tie)
    load_flax_params(model, params)
    return params, model


def _assert_trees_equal(got, ref, path=""):
    assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(ref[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("bits,min_dim", [(8, 256), (8, 128), (4, 128)])
def test_converter_gives_jax_quantize_decoder_params(lm_pair, bits,
                                                     min_dim):
    params, model = lm_pair
    ref = jq.quantize_decoder_params(params, min_dim=min_dim, bits=bits)
    qmodel = tq.quantize_decoder_params(model, min_dim=min_dim, bits=bits)
    _assert_trees_equal(flax_params_from_model(qmodel),
                        jax.tree_util.tree_map(np.asarray, ref))
    assert tq.quantized_bytes(qmodel) == jq.quantized_bytes(ref)
    # the source model is untouched
    _assert_trees_equal(flax_params_from_model(model), params)


def test_int4_converter_mixes_q4_and_int8_fallback(lm_pair):
    _, model = lm_pair
    q = tq.quantize_decoder_params(model, min_dim=128, bits=4)
    attn = q.model.layer_0.self_attn
    assert hasattr(attn.q_proj, "kernel_q4")
    assert hasattr(attn.kv_a_proj_with_mqa, "kernel_q4")
    assert hasattr(attn.o_proj, "kernel_q")  # 128-row reduction: int8
    assert hasattr(attn.kv_b_proj, "weight")  # absorbed, never quantized
    moe = q.model.layer_1.moe
    assert hasattr(moe, "w_gate_q4") and hasattr(moe, "w_down_q")
    assert not hasattr(moe, "w_gate") and moe.router_weight.dtype == \
        torch.float32
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tq.quantize_decoder_params(model, bits=2)


def test_jax_quantized_tree_round_trips_through_convert(lm_pair):
    params, model = lm_pair
    ref = jax.tree_util.tree_map(
        np.asarray, jq.quantize_decoder_params(params, min_dim=128, bits=4))
    qmodel = tq.quantize_decoder_params(
        DeepSeekForCausalLM(lm_cfg(tcfg), VOCAB,
                            generator=torch.Generator().manual_seed(1),
                            device="cpu",
                            tie_embeddings=model.tie_embeddings),
        min_dim=128, bits=4)
    load_flax_params(qmodel, ref)
    assert qmodel.model.layer_1.moe.w_gate_q4.dtype == torch.int8
    _assert_trees_equal(flax_params_from_model(qmodel), ref)


def test_chip_smoke_decode_model_is_bench_decode():
    """chip_smoke's decode model (phase 18) at tools/bench_decode.py's
    config, built on the meta device (no memory): BENCH_DECODE.json's
    parameter count, tree bytes, quantized shares and cache bytes, and the
    K6 / K7 products per step that phase 18 asserts."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    with open(os.path.join(repo, "BENCH_DECODE.json")) as fh:
        bench = json.load(fh)
    model = DeepSeekForCausalLM(
        chip_smoke.decode_config(), chip_smoke.DECODE_VOCAB,
        generator=torch.Generator(), device="meta",
        compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e9, 3) == bench["params_b"]
    assert tq.quantized_bytes(model)["total_bytes"] == \
        bench["int8"]["weight_bytes_bf16"] == \
        chip_smoke.BENCH_DECODE_BYTES["bf16"]
    trees = chip_smoke.decode_trees_on_meta()
    for bits, kernel in ((8, "kernel_q"), (4, "kernel_q4")):
        key = f"int{bits}"
        q = trees[bits]
        got = tq.quantized_bytes(q)
        assert got["total_bytes"] == bench[key][f"weight_bytes_{key}_tree"] \
            == chip_smoke.BENCH_DECODE_BYTES[key]
        assert round(got["int8_bytes"] / got["total_bytes"], 3) == \
            bench[key][f"{key}_weight_fraction"]
        dense = sum(hasattr(m, kernel) for m in q.modules())
        moe = sum(tq.is_quantized_moe(m) for m in q.modules())
        assert dense + 3 * moe == chip_smoke.QUANT_PER_STEP == 177
        # phase 17's step products at B=8: 20 MLA layers (q_proj,
        # kv_a_proj_with_mqa, o_proj), layer 0's SwiGLU, 19 MoE layers'
        # shared expert and experts (capacity factor 2.0: 4 slots each)
        assert chip_smoke.decode_products(q, 8) == {
            (bits, *k): n for k, n in {
                (1, 8, 2048, 3072): 20, (1, 8, 2048, 576): 20,
                (1, 8, 2048, 2048): 20, (1, 8, 2048, 8192): 2,
                (1, 8, 8192, 2048): 1, (1, 8, 2048, 1024): 38,
                (1, 8, 1024, 2048): 19, (16, 4, 2048, 1024): 38,
                (16, 4, 1024, 2048): 19}.items()}
    from deepearth_tpu_torch.models import cache_bytes_per_token
    assert cache_bytes_per_token(model.cfg.mla, 2) == \
        bench["cache_bytes_per_token_per_layer"]
