"""Autoregressive generation for :class:`DeepSeekForCausalLM` over the
compressed MLA cache, PyTorch port of ``deepearth_tpu/models/generation.py``.

A step runs every layer on one token per sequence: :func:`mla_decode
.decode_step` for attention, the dense SwiGLU or the MoE layer, each dense
projection through ``ops.quant.linear_p`` and the experts through
``ops.quant.expert_ffn_q`` when the model was quantized
(``ops.quant.quantize_decoder_params``): on the card those are the kernels
K6 (int8) and K7 (int4). The MoE layers of decode always take the one-hot
capacity dispatch (``make_dispatch_combine``), as the JAX package's decode
does, whatever their ``dispatch_mode``.

Not ported: the JAX package's cache of compiled decode programs
(``_RUN_CACHE``), a jit artifact; eager PyTorch has nothing to cache.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepSeekBlockConfig
from ..ops import moe as moe_ops
from ..ops.quant import expert_ffn_q, is_quantized_moe, linear_p
from .deepseek import capacity, layer_uses_moe
from .mla_decode import MLACache, decode_step, init_cache, rms


def _swiglu_apply(mlp, x: torch.Tensor) -> torch.Tensor:
    gate = linear_p(mlp.gate_proj, x)
    up = linear_p(mlp.up_proj, x)
    return linear_p(mlp.down_proj, F.silu(gate) * up)


def _moe_apply(moe, cfg, x: torch.Tensor) -> torch.Tensor:
    """An ``MoELayer``'s forward over its parameters (plain or quantized):
    fp32 router, group-limited top-k, the one-hot dispatch with capacity
    S K (drop-free) when ``capacity_factor`` is None, the experts, the
    combine and the shared expert."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    gate = moe_ops.moe_gate(
        xf.float() @ moe.router_weight.T, moe.e_score_correction_bias,
        top_k=cfg.num_experts_per_tok, n_group=cfg.n_group,
        topk_group=cfg.topk_group, norm_topk_prob=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor)
    dispatch, combine, _ = moe_ops.make_dispatch_combine(
        gate.topk_idx, gate.topk_weight, n_experts=cfg.n_routed_experts,
        capacity=capacity(cfg, xf.shape[0]))
    expert_in = torch.einsum("sec,sd->ecd", dispatch.to(xf.dtype), xf)
    if is_quantized_moe(moe):
        expert_out = expert_ffn_q(moe, expert_in)
    else:
        dt = torch.promote_types(xf.dtype, moe.w_gate.dtype)
        expert_out = moe_ops.expert_ffn(
            expert_in.to(dt), *(w.to(dt) for w in (moe.w_gate, moe.w_up,
                                                    moe.w_down)))
    dt = torch.promote_types(xf.dtype, expert_out.dtype)
    y = torch.einsum("sec,ecd->sd", combine.to(dt), expert_out.to(dt))
    if cfg.n_shared_experts:
        y = y + _swiglu_apply(moe.shared_experts, xf)
    return y.reshape(shape).to(x.dtype)


def causal_lm_decode_step(model, caches: List[MLACache],
                          token_ids: torch.Tensor, max_len: int
                          ) -> Tuple[torch.Tensor, List[MLACache]]:
    """One decode step through every layer of a ``DeepSeekForCausalLM``
    (plain or quantized).

    Args:
        caches: one :class:`MLACache` per layer, updated in place.
        token_ids: (B,) current tokens.

    Returns:
        (B, vocab) float32 logits for the next token and the caches.
    """
    cfg: DeepSeekBlockConfig = model.cfg
    emb = model.embed_tokens.weight
    h = emb[token_ids.long()][:, None, :]  # (B, 1, D)
    new_caches = []
    for i in range(cfg.n_layers):
        layer = getattr(model.model, f"layer_{i}")
        hn = rms(h, layer.input_layernorm.weight, cfg.rms_norm_eps)
        attn, c = decode_step(layer.self_attn, cfg.mla, caches[i], hn,
                              max_len)
        new_caches.append(c)
        h = h + attn
        hn = rms(h, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
        if layer_uses_moe(cfg, i):
            h = h + _moe_apply(layer.moe, cfg.moe, hn)
        else:
            h = h + _swiglu_apply(layer.mlp, hn)
    h = rms(h, model.model.norm.weight, cfg.rms_norm_eps)
    if model.tie_embeddings:
        dt = torch.promote_types(h.dtype, emb.dtype)
        logits = h.to(dt) @ emb.to(dt).T
    else:
        logits = linear_p(model.lm_head, h)
    return logits[:, 0].float(), new_caches


def sample(logits: torch.Tensor, temperature: float, top_k: Optional[int],
           generator: torch.Generator) -> torch.Tensor:
    """Next tokens (B,) int32 from (B, vocab) logits. With ``top_k``, logits
    below the k-th largest are dropped. ``temperature`` 0 is greedy (the
    first largest); above 0, a categorical draw at logits / max(t, 1e-6)
    (Gumbel-max, the noise from ``generator``)."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if not temperature > 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    scaled = logits / max(float(temperature), 1e-6)
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(model, input_ids: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             cache_dtype: torch.dtype = torch.float32,
             prompt_len: Optional[int] = None) -> torch.Tensor:
    """Greedy or temperature sampling over the compressed-cache decoder.

    Args:
        input_ids: (B, S) prompt on the model's device, optionally
            right-padded (see ``prompt_len``).
        max_new_tokens: tokens to sample.
        temperature: 0 greedy; > 0 softmax sampling, optionally top-k
            filtered, the draws from ``generator`` (on the model's device;
            seed 0 if None).
        prompt_len: the valid leading prompt tokens (default S). The pads
            go through the model, but the caches' lengths are reset to
            ``prompt_len`` after the prompt, so decode overwrites their slots
            and attends to none of them.

    Returns:
        (B, max_new_tokens) int32 tokens.
    """
    B, S = input_ids.shape
    max_len = max_len or (S + max_new_tokens)
    prompt_len = S if prompt_len is None else int(prompt_len)
    device = model.embed_tokens.weight.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    caches = [init_cache(model.cfg.mla, B, max_len, cache_dtype, device)
              for _ in range(model.cfg.n_layers)]
    # the prompt goes through token by token, as the JAX package's scan
    last = None
    for t in range(S):
        logits, caches = causal_lm_decode_step(model, caches, input_ids[:, t],
                                               max_len)
        if t == prompt_len - 1:
            last = logits
    caches = [c._replace(length=prompt_len) for c in caches]
    tok = sample(last, temperature, top_k, generator)
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        logits, caches = causal_lm_decode_step(model, caches, tok, max_len)
        tok = sample(logits, temperature, top_k, generator)
        toks.append(tok)
    return torch.stack(toks, dim=1)
