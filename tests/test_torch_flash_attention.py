"""K4's plain versions against the library flash kernel, on the CPU.

The JAX side is the call that ``deepearth_tpu/models/deepseek.py``
``MLAttention`` makes on the TPU (v zero-padded to q's head dim, segment ids
from the key mask, ``_flash_block_sizes``), run here under
``pltpu.force_tpu_interpret_mode()``; its gradients come from ``jax.vjp``.
The port runs :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain` (and the autograd.Function, which takes
them for CPU tensors) on the same numpy inputs at the MLA's head dims
(Dqk 48, Dv 32), N = 256, where the library runs one block per row.

Tolerances: fp32 2e-5 of each output's largest entry (the same fp32 math
summed in other orders); bf16 one bf16 ulp of each output's largest entry
(the library's backward takes p as exp(s - m) / l, the port's as
exp(s - lse), so a p or ds rounded to bf16 may land on the other
neighbour). Every row sees at least one key (key 0 stays visible), except in
the test that pins where the two differ: a row whose keys are all masked.

Heads wider than 128 (192 / 128, DeepSeek-V3's MLA, and 256 / 256) are held
against JAX's ``dot_product_attention``, the einsum path JAX takes on the
CPU, and its ``jax.vjp``, with a key mask and causal: fp32, 2e-5 of each
output's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    flash_attention,
)

from deepearth_tpu.models.deepseek import _flash_block_sizes
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

B, H, N, DQK, DV = 2, 2, 256, 48, 32
SCALE = DQK ** -0.5
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = {  # name: (dtype, key mask, causal)
    "fp32": ("fp32", False, False),
    "fp32_key_mask": ("fp32", True, False),
    "fp32_causal": ("fp32", False, True),
    "bf16_key_mask_causal": ("bf16", True, True),
    "bf16": ("bf16", False, False),  # the vision MLA's case
}


def numpy_inputs(seed, all_masked_row=False):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, H, N, DQK)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((B, H, N, DV)).astype(np.float32)
             for _ in range(2))
    mask = rng.uniform(size=(B, N)) > 0.3
    mask[:, 0] = True  # every causal row sees a key
    if all_masked_row:
        mask[0] = False
    return q, k, v, do, mask


def library_call(q, k, v, mask, causal):
    """The JAX package's flash call at its MLA site (deepseek.py:230-275):
    v zero-padded to q's head dim, segment ids 1 for real queries and
    visible keys, 0 for masked keys; N = 256 needs no sequence padding."""
    v_in = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, DQK - DV)))
    segment_ids = None
    if mask is not None:
        segment_ids = SegmentIds(q=jnp.ones((B, N), jnp.int32),
                                 kv=jnp.asarray(mask).astype(jnp.int32))
    return flash_attention(q, k.astype(q.dtype), v_in.astype(q.dtype),
                           segment_ids=segment_ids, causal=causal,
                           sm_scale=SCALE,
                           block_sizes=_flash_block_sizes(N))[:, :, :N, :DV]


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def library():
    """The library's outputs and gradients for every case, computed once
    (one interpret-mode forward and backward is a few seconds)."""
    out = {}
    for name, (dtype, masked, causal) in CASES.items():
        q, k, v, do, mask = numpy_inputs(len(out))
        jdt = DTYPES[dtype][0]
        m = mask if masked else None
        with pltpu.force_tpu_interpret_mode():
            o, vjp = jax.vjp(lambda q_, k_, v_: library_call(
                q_, k_, v_, m, causal), *(jnp.asarray(x).astype(jdt)
                                          for x in (q, k, v)))
            grads = vjp(jnp.asarray(do).astype(jdt))
        out[name] = (f32(o), [f32(g) for g in grads])
    return out


def tolerance(ref, dtype):
    top = float(np.abs(ref).max())
    if dtype == "fp32":
        return 2e-5 * top
    return 2.0 ** (np.floor(np.log2(top)) - 7)  # one bf16 ulp of the top


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_the_library_kernel(library, name):
    dtype, masked, causal = CASES[name]
    q, k, v, do, mask = numpy_inputs(list(CASES).index(name))
    tdt = DTYPES[dtype][1]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    kw = dict(scale=SCALE, key_mask=torch.from_numpy(mask) if masked else None,
              causal=causal)
    out, lse = tflash.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    grads = tflash.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, **kw)
    ref_out, ref_grads = library[name]
    assert out.dtype == tdt and out.shape == (B, H, N, DV)
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=0,
                               atol=tolerance(ref_out, dtype))
    for got, ref, label in zip(grads, ref_grads, ("dq", "dk", "dv")):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tolerance(ref, dtype), err_msg=label)

    # the autograd.Function takes the same plain versions for CPU tensors
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    kernels.reset_launch_counts()
    again = tflash.flash_attention(*leaves, **kw)
    again.backward(tdo)
    assert set(kernels.launch_counts.values()) == {0}
    assert torch.equal(again, out)
    for leaf, g in zip(leaves, grads):
        assert torch.equal(leaf.grad, g)


def test_all_masked_row_is_zero_where_the_library_gives_the_mean_of_v():
    """The divergence, pinned: every key of batch row 0 masked. The library
    kernel adds a finite mask value and guards only a zero sum, so the row's
    softmax is uniform and its output the mean of v over all N keys; the
    port keeps the repository's convention, 0 (and p = 0 in the backward,
    so no gradient)."""
    q, k, v, do, mask = numpy_inputs(9, all_masked_row=True)
    with pltpu.force_tpu_interpret_mode():
        ref = f32(library_call(*(jnp.asarray(x) for x in (q, k, v)), mask,
                               False))
    np.testing.assert_allclose(
        ref[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True),
                                (H, N, DV)), rtol=0, atol=1e-6)
    assert np.abs(ref[0]).max() > 0.01
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = dict(scale=SCALE, key_mask=torch.from_numpy(mask))
    out, lse = tflash.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert not out[0].any() and bool(lse[0].isinf().all())
    np.testing.assert_allclose(out[1].numpy(), ref[1], rtol=0,
                               atol=2e-5 * np.abs(ref[1]).max())
    dq, dk, dv = tflash.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                                  **kw)
    assert not dq[0].any() and not dk[0].any() and not dv[0].any()


def test_supported_head_dims():
    assert tflash.supported(48, 32) and tflash.supported(128, 128)
    assert tflash.supported(192, 128) and tflash.supported(256, 256)
    assert tflash.supported(64, 129)
    assert not tflash.supported(264, 128) and not tflash.supported(64, 257)


# Heads wider than 128 (DeepSeek-V3's MLA, 192 / 128, and the widest the
# JAX package's padding gives, 256 / 256), held against JAX's
# dot_product_attention, the einsum path JAX takes on the CPU, and its
# jax.vjp: fp32, 2e-5 of each output's largest entry.
WIDE = {  # name: (Dqk, Dv, key mask, causal)
    "192_128": (192, 128, False, False),
    "192_128_key_mask_causal": (192, 128, True, True),
    "256_256_key_mask": (256, 256, True, False),
    "256_256_causal": (256, 256, False, True),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_plain_versions_at_wide_heads_match_jax_attention(name):
    from deepearth_tpu.ops.attention import dot_product_attention

    dqk, dv, masked, causal = WIDE[name]
    b, h, n = 2, 2, 40
    rng = np.random.default_rng(20 + list(WIDE).index(name))
    q, k = (rng.standard_normal((b, h, n, dqk)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((b, h, n, dv)).astype(np.float32)
             for _ in range(2))
    mask = rng.uniform(size=(b, n)) > 0.3
    mask[:, 0] = True  # every causal row sees a key
    scale = dqk ** -0.5
    jmask = jnp.asarray(mask) if masked else None
    ref, vjp = jax.vjp(lambda q_, k_, v_: dot_product_attention(
        q_, k_, v_, scale=scale, key_mask=jmask, is_causal=causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = dict(scale=scale, key_mask=torch.from_numpy(mask) if masked else None,
              causal=causal)
    out, lse = tflash.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    grads = tflash.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, **kw)
    assert out.shape == (b, h, n, dv)
    np.testing.assert_allclose(out.numpy(), f32(ref), rtol=0,
                               atol=tolerance(f32(ref), "fp32"))
    for got, r, label in zip(grads, ref_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), f32(r), rtol=0,
                                   atol=tolerance(f32(r), "fp32"),
                                   err_msg=label)
    # the autograd.Function takes the same plain versions for CPU tensors
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    again = tflash.flash_attention(*leaves, **kw)
    again.backward(tdo)
    assert torch.equal(again, out)
    for leaf, g in zip(leaves, grads):
        assert torch.equal(leaf.grad, g)
