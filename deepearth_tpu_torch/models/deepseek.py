"""DeepSeek-style components, PyTorch port of the dense parts of
``deepearth_tpu/models/deepseek.py``: MLA attention, the SwiGLU MLP, the
decoder block and the sequential stack.

MLA attention over at least ``flash_min_seq`` tokens (with
``use_flash_attention``) runs the flash kernels K4-fwd/K4-bwd on the card,
as the JAX package runs its library flash kernel on the TPU; on the CPU it
stays on ``dot_product_attention``, as the JAX package does there. Not
ported yet, and refused where a config asks for them: MoE layers
(ROADMAP.md Queue 1, item 12), ring attention over a mesh and pipelined
stages (item 15).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import DeepSeekBlockConfig, MLAConfig
from ..ops import flash_attention as flash
from ..ops.attention import dot_product_attention
from ..ops.norms import RMSNorm
from ..ops.rope import apply_rope_deepseek, rope_tables, yarn_get_mscale
from .layers import Dense, Init, dropout

FLASH_SHAPE = (
    "MLA attention over {n} >= flash_min_seq={m} tokens runs the flash "
    "kernel K4 on the card, which takes head dims up to {most}, not Dqk "
    "{qh} and Dv {vh}: wider heads (DeepSeek-V3's 192) wait for ROADMAP.md "
    "Queue 1, item 13")
MOE_TODO = ("MoE layers are not ported yet (ROADMAP.md Queue 1, item 12: "
            "ops/moe.py and the MoE block of models/deepseek.py)")
PIPELINE_TODO = ("pipelined DeepSeek stacks (pipeline_stages > 1) are not "
                 "ported yet (ROADMAP.md Queue 1, item 15)")


class MLAttention(nn.Module):
    """Multi-head Latent Attention. Queries optionally go through a LoRA
    bottleneck (q_a/q_b + RMSNorm); keys and values are compressed to
    ``kv_lora_rank`` plus one rope head shared by all heads, then
    decompressed per head. Positions enter only through the
    ``qk_rope_head_dim`` slice (deepseek RoPE)."""

    def __init__(self, cfg: MLAConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        D, H, cd = cfg.hidden_dim, cfg.n_heads, compute_dtype
        qh, nope, vh = cfg.q_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
        bias = cfg.attention_bias
        if cfg.q_lora_rank is None:
            self.q_proj = Dense(D, H * qh, init, cd, use_bias=False)
        else:
            self.q_a_proj = Dense(D, cfg.q_lora_rank, init, cd, use_bias=bias)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, device=init.device)
            self.q_b_proj = Dense(cfg.q_lora_rank, H * qh, init, cd,
                                  use_bias=False)
        self.kv_a_proj_with_mqa = Dense(
            D, cfg.kv_lora_rank + cfg.qk_rope_head_dim, init, cd,
            use_bias=bias)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, device=init.device)
        self.kv_b_proj = Dense(cfg.kv_lora_rank, H * (nope + vh), init, cd,
                               use_bias=False)
        self.o_proj = Dense(H * vh, D, init, cd, use_bias=bias)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                is_causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, N, D); key_mask optional (B, N) bool. Returns (B, N, D)."""
        cfg = self.cfg
        B, N, _ = x.shape
        H, rope_d = cfg.n_heads, cfg.qk_rope_head_dim
        qh, nope, vh = cfg.q_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
        # the gate decides from the config and the device type alone
        use_flash = (cfg.use_flash_attention and N >= cfg.flash_min_seq
                     and x.is_cuda)
        if use_flash and not flash.supported(qh, vh):
            raise ValueError(FLASH_SHAPE.format(
                n=N, m=cfg.flash_min_seq, most=flash.MAX_DIM, qh=qh, vh=vh))

        if cfg.q_lora_rank is None:
            q = self.q_proj(x)
        else:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        q = q.view(B, N, H, qh).transpose(1, 2)
        q_nope, q_pe = q[..., :nope], q[..., nope:]

        ckv = self.kv_a_proj_with_mqa(x)
        compressed_kv = ckv[..., : cfg.kv_lora_rank]
        k_pe = ckv[..., cfg.kv_lora_rank:].view(B, 1, N, rope_d)
        kv = self.kv_b_proj(self.kv_a_layernorm(compressed_kv))
        kv = kv.view(B, N, H, nope + vh).transpose(1, 2)
        k_nope, v = kv[..., :nope], kv[..., nope:]

        scaling = cfg.rope_scaling if cfg.rope_scaling.type != "none" else None
        cos, sin = rope_tables(N, rope_d, cfg.rope_theta, scaling,
                               device=x.device)
        q_pe = apply_rope_deepseek(q_pe, cos, sin).to(q_nope.dtype)
        k_pe = apply_rope_deepseek(k_pe, cos, sin).to(k_nope.dtype)
        query = torch.cat([q_nope, q_pe], dim=-1)
        key = torch.cat([k_nope, k_pe.expand(B, H, N, rope_d)], dim=-1)

        scale = qh ** -0.5
        rs = cfg.rope_scaling
        if rs.type == "yarn" and rs.mscale_all_dim:
            ms = yarn_get_mscale(rs.factor, rs.mscale_all_dim)
            scale = scale * ms * ms

        if use_flash:
            out = flash.flash_attention(
                query, key.to(query.dtype), v.to(query.dtype), scale=scale,
                key_mask=key_mask, causal=is_causal).to(v.dtype)
        else:
            out = dot_product_attention(query, key, v, scale=scale,
                                        key_mask=key_mask,
                                        is_causal=is_causal)
        out = self.o_proj(out.transpose(1, 2).reshape(B, N, H * vh))
        return dropout(out, cfg.attention_dropout, self.training, generator)


class SwiGLUMLP(nn.Module):
    """Dense SwiGLU MLP: down(silu(gate(x)) * up(x)), gate and up as one
    matmul."""

    def __init__(self, hidden_dim: int, intermediate_size: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype = cd
        self.gate_proj = Dense(hidden_dim, intermediate_size, init, cd,
                               use_bias=False)
        self.up_proj = Dense(hidden_dim, intermediate_size, init, cd,
                             use_bias=False)
        self.down_proj = Dense(intermediate_size, hidden_dim, init, cd,
                               use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        w = torch.cat([self.gate_proj.weight, self.up_proj.weight]).to(cd)
        gate, up = F.linear(x.to(cd), w).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


def layer_uses_moe(cfg: DeepSeekBlockConfig, i: int) -> bool:
    return (cfg.moe is not None and i >= cfg.first_k_dense_replace
            and i % cfg.moe_layer_freq == 0)


class DeepSeekBlock(nn.Module):
    """Pre-RMSNorm decoder block: MLA + dense SwiGLU MLP. A layer that the
    config makes an MoE layer raises."""

    def __init__(self, cfg: DeepSeekBlockConfig, layer_idx: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        if layer_uses_moe(cfg, layer_idx):
            raise NotImplementedError(MOE_TODO)
        dev = init.device
        self.input_layernorm = RMSNorm(cfg.hidden_dim, cfg.rms_norm_eps,
                                       device=dev)
        self.self_attn = MLAttention(cfg.mla, init, compute_dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_dim,
                                                cfg.rms_norm_eps, device=dev)
        self.mlp = SwiGLUMLP(cfg.hidden_dim, cfg.intermediate_size, init,
                             compute_dtype)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                is_causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), key_mask, is_causal,
                               generator)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepSeekTransformer(nn.Module):
    """``n_layers`` decoder blocks and a final RMSNorm, run in sequence."""

    def __init__(self, cfg: DeepSeekBlockConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        if cfg.pipeline_stages and cfg.pipeline_stages > 1:
            raise NotImplementedError(PIPELINE_TODO)
        self.n_layers = cfg.n_layers
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}",
                            DeepSeekBlock(cfg, i, init, compute_dtype))
        self.norm = RMSNorm(cfg.hidden_dim, cfg.rms_norm_eps,
                            device=init.device)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                is_causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, key_mask, is_causal, generator)
        return self.norm(x)
