"""MLA decoding with a compressed KV cache, PyTorch port of
``deepearth_tpu/models/mla_decode.py``.

Multi-head Latent Attention caches, per token, only the rank-compressed
latent (``kv_lora_rank`` values, after its RMSNorm) and the rope key shared
by all heads, not each head's K and V. A decode step absorbs the key
projection into the query (``q_eff = q_nope . W_k^T``), so the scores are
taken against the cached latents directly, and applies the value projection
after the probability-weighted latent sum. It reads the parameters of an
unmodified :class:`MLAttention` (plain, or quantized by
``ops.quant.quantize_decoder_params``, whose ``kv_b_proj`` stays as it is).

The attention is plain einsums, as in the JAX package: no kernel of its own.
Unlike the JAX package's functional update, :func:`decode_step` writes the
new token into the cache's tensors in place (one slot, not a copy of the
cache) and returns the cache with its length advanced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..configs import MLAConfig
from ..ops.quant import linear_p
from ..ops.rope import apply_rope_deepseek, rope_tables, yarn_get_mscale


class MLACache(NamedTuple):
    """(B, max_len, kv_lora_rank) latents (after their RMSNorm), (B, max_len,
    qk_rope_head_dim) shared rope keys, and the number of slots filled."""

    ckv: torch.Tensor
    k_pe: torch.Tensor
    length: int


def init_cache(cfg: MLAConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cuda") -> MLACache:
    """An empty cache on ``device`` (the card unless the caller names
    another)."""
    return MLACache(
        ckv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
        k_pe=torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                         device=device),
        length=0)


def cache_bytes_per_token(cfg: MLAConfig, dtype_bytes: int = 4) -> int:
    return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * dtype_bytes


def full_cache_bytes_per_token(cfg: MLAConfig, dtype_bytes: int = 4) -> int:
    """What a standard attention cache would cost (per-head K + V)."""
    return cfg.n_heads * (cfg.q_head_dim + cfg.v_head_dim) * dtype_bytes


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
        ) -> torch.Tensor:
    """The decode path's RMSNorm: fp32 statistics, normalised value cast to
    x's type before the weight multiplies it, then cast again."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (weight * (xf * torch.rsqrt(var + eps)).to(x.dtype)).to(x.dtype)


def softmax_scale(cfg: MLAConfig) -> float:
    scale = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs.type == "yarn" and rs.mscale_all_dim:
        ms = yarn_get_mscale(rs.factor, rs.mscale_all_dim)
        scale = scale * ms * ms
    return scale


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum in the promoted type of its operands, as jnp.einsum."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def decode_step(attn, cfg: MLAConfig, cache: MLACache, x_t: torch.Tensor,
                max_len: int) -> Tuple[torch.Tensor, MLACache]:
    """One decode step of an :class:`MLAttention` ``attn``.

    Args:
        x_t: (B, 1, hidden) current-token activations.
        max_len: the cache's capacity (the rope tables are sized to it).

    Returns:
        (B, 1, hidden) attention output and the cache, its tensors updated
        in place at slot ``cache.length`` and its length advanced.
    """
    B = x_t.shape[0]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pos = cache.length

    if cfg.q_lora_rank is None:
        q = linear_p(attn.q_proj, x_t)
    else:
        qa = rms(linear_p(attn.q_a_proj, x_t), attn.q_a_layernorm.weight)
        q = linear_p(attn.q_b_proj, qa)
    q = q.reshape(B, 1, H, cfg.q_head_dim).transpose(1, 2)  # (B, H, 1, qh)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    ckv_full = linear_p(attn.kv_a_proj_with_mqa, x_t)
    ckv_t = rms(ckv_full[..., :r], attn.kv_a_layernorm.weight)  # (B, 1, r)
    kpe_t = ckv_full[..., r:]  # (B, 1, rope_d)

    scaling = cfg.rope_scaling if cfg.rope_scaling.type != "none" else None
    cos, sin = rope_tables(max_len, rope_d, cfg.rope_theta, scaling,
                           device=x_t.device)
    cos_t, sin_t = cos[pos:pos + 1], sin[pos:pos + 1]
    q_pe = apply_rope_deepseek(q_pe, cos_t, sin_t).to(q_nope.dtype)
    kpe_t = apply_rope_deepseek(kpe_t[:, None], cos_t, sin_t)[:, 0].to(
        ckv_t.dtype)

    # the cache keeps its own type (params may be bf16 with an fp32 cache,
    # or the other way round)
    cache.ckv[:, pos:pos + 1] = ckv_t.to(cache.ckv.dtype)
    cache.k_pe[:, pos:pos + 1] = kpe_t.to(cache.k_pe.dtype)
    cache = cache._replace(length=pos + 1)

    # kv_b_proj's weight is (H (nope + vh), r): W_k (H, nope, r), W_v (H, vh, r)
    w_kv_b = attn.kv_b_proj.weight.view(H, nope + vh, r)
    w_k, w_v = w_kv_b[:, :nope], w_kv_b[:, nope:]

    q_eff = _einsum("bhtn,hnr->bhtr", q_nope, w_k)  # (B, H, 1, r)
    scores = (torch.einsum("bhtr,bsr->bhts", q_eff.float(), cache.ckv.float())
              + torch.einsum("bhtp,bsp->bhts", q_pe.float(),
                             cache.k_pe.float()))
    scores = scores * softmax_scale(cfg)
    valid = torch.arange(max_len, device=x_t.device) < cache.length
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cache.ckv.dtype)

    ctx_latent = torch.einsum("bhts,bsr->bhtr", probs, cache.ckv)
    ctx = _einsum("bhtr,hvr->bhtv", ctx_latent, w_v)  # (B, H, 1, vh)
    out = ctx.transpose(1, 2).reshape(B, 1, H * vh)
    return linear_p(attn.o_proj, out), cache


def decode_sequence(attn, cfg: MLAConfig, xs: torch.Tensor,
                    max_len: Optional[int] = None) -> torch.Tensor:
    """Decode a whole (B, S, D) sequence token by token (the reference path
    of the tests; generation drives :func:`decode_step` from its loop)."""
    B, S, _ = xs.shape
    max_len = max_len or S
    cache = init_cache(cfg, B, max_len, xs.dtype, xs.device)
    outs = []
    for t in range(S):
        o, cache = decode_step(attn, cfg, cache, xs[:, t:t + 1], max_len)
        outs.append(o)
    return torch.cat(outs, dim=1)
