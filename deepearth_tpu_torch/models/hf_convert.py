"""HF / torch DeepSeek-V3 checkpoints to the port's parameters, the port's
numpy copy of ``deepearth_tpu/models/hf_convert.py`` over its own configs.

:func:`convert_hf_state_dict` turns an HF ``DeepseekV3ForCausalLM``
state_dict into the flax-named tree of the JAX package's
``DeepSeekForCausalLM`` (q-LoRA split, stacked ``(E, D, F)`` expert
weights, the router bias, kernels transposed to (in, out)), as numpy
float32; ``convert.load_flax_params`` then loads it into the port's
:class:`DeepSeekForCausalLM` (:func:`load_hf_model`). Converted checkpoints
carry an ``lm_head`` (``tie_embeddings=False``, as in JAX).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..configs import (
    DeepSeekBlockConfig,
    MLAConfig,
    MoEConfig,
    RopeScalingConfig,
)


def _np(t) -> np.ndarray:
    """torch tensor | numpy array → float32 numpy array."""
    if hasattr(t, "detach"):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t, dtype=np.float32)


def _linear(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch Linear → flax Dense params (kernel transposed)."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _norm(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"weight": _np(sd[f"{prefix}.weight"])}


def _swiglu(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "gate_proj": _linear(sd, f"{prefix}.gate_proj"),
        "up_proj": _linear(sd, f"{prefix}.up_proj"),
        "down_proj": _linear(sd, f"{prefix}.down_proj"),
    }


def config_from_hf(hf_cfg) -> Tuple[DeepSeekBlockConfig, int]:
    """HF DeepseekV3Config → (DeepSeekBlockConfig, vocab_size).

    Accepts the config object or a plain dict (config.json contents).
    """
    get = (lambda k, d=None: getattr(hf_cfg, k, d)) if not isinstance(
        hf_cfg, dict
    ) else (lambda k, d=None: hf_cfg.get(k, d))

    rs = get("rope_scaling") or {}
    scaling = RopeScalingConfig(
        type=rs.get("type", "none") if rs else "none",
        factor=rs.get("factor", 1.0) if rs else 1.0,
        original_max_position_embeddings=rs.get(
            "original_max_position_embeddings", 4096
        )
        if rs
        else 4096,
        beta_fast=rs.get("beta_fast", 32.0) if rs else 32.0,
        beta_slow=rs.get("beta_slow", 1.0) if rs else 1.0,
        mscale=rs.get("mscale", 1.0) if rs else 1.0,
        mscale_all_dim=rs.get("mscale_all_dim", 0.0) if rs else 0.0,
    )
    mla = MLAConfig(
        hidden_dim=get("hidden_size"),
        n_heads=get("num_attention_heads"),
        q_lora_rank=get("q_lora_rank"),
        kv_lora_rank=get("kv_lora_rank"),
        qk_rope_head_dim=get("qk_rope_head_dim"),
        qk_nope_head_dim=get("qk_nope_head_dim"),
        v_head_dim=get("v_head_dim"),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=scaling,
        attention_bias=bool(get("attention_bias", False)),
        attention_dropout=get("attention_dropout", 0.0),
        max_position_embeddings=get("max_position_embeddings", 4096),
    )
    moe = None
    if get("n_routed_experts"):
        moe = MoEConfig(
            n_routed_experts=get("n_routed_experts"),
            num_experts_per_tok=get("num_experts_per_tok"),
            n_group=get("n_group", 1) or 1,
            topk_group=get("topk_group", 1) or 1,
            routed_scaling_factor=get("routed_scaling_factor", 1.0),
            norm_topk_prob=bool(get("norm_topk_prob", True)),
            n_shared_experts=get("n_shared_experts"),
            moe_intermediate_size=get("moe_intermediate_size"),
            hidden_dim=get("hidden_size"),
            # Drop-free dispatch: converted checkpoints must reproduce the
            # reference's exact (capacity-less) routing.
            capacity_factor=None,
        )
    cfg = DeepSeekBlockConfig(
        hidden_dim=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        intermediate_size=get("intermediate_size"),
        mla=mla,
        moe=moe,
        first_k_dense_replace=get("first_k_dense_replace", 0),
        moe_layer_freq=get("moe_layer_freq", 1),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
    )
    return cfg, get("vocab_size")


def convert_hf_state_dict(
    sd: Dict[str, Any],
    cfg: DeepSeekBlockConfig,
    tie_embeddings: bool = False,
) -> Dict[str, Any]:
    """HF DeepseekV3ForCausalLM state_dict → DeepSeekForCausalLM flax params.

    Handles (reference: encoders/modeling_deepseek.py):
      * q-LoRA split (q_a_proj/q_a_layernorm/q_b_proj vs plain q_proj, :656-667)
      * kv compression pair kv_a_proj_with_mqa / kv_b_proj (:669-688)
      * MoE router weight + e_score_correction_bias (:417-424) and the
        per-expert Linear stacks → our batched ``(E, D, F)`` tensors
      * dense/MoE layer pattern via first_k_dense_replace / moe_layer_freq
    """
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": _np(sd["model.embed_tokens.weight"])}
    }
    model: Dict[str, Any] = {"norm": _norm(sd, "model.norm")}

    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}"
        attn: Dict[str, Any] = {}
        if cfg.mla.q_lora_rank is None:
            attn["q_proj"] = _linear(sd, f"{pre}.self_attn.q_proj")
        else:
            attn["q_a_proj"] = _linear(sd, f"{pre}.self_attn.q_a_proj")
            attn["q_a_layernorm"] = _norm(sd, f"{pre}.self_attn.q_a_layernorm")
            attn["q_b_proj"] = _linear(sd, f"{pre}.self_attn.q_b_proj")
        attn["kv_a_proj_with_mqa"] = _linear(
            sd, f"{pre}.self_attn.kv_a_proj_with_mqa"
        )
        attn["kv_a_layernorm"] = _norm(sd, f"{pre}.self_attn.kv_a_layernorm")
        attn["kv_b_proj"] = _linear(sd, f"{pre}.self_attn.kv_b_proj")
        attn["o_proj"] = _linear(sd, f"{pre}.self_attn.o_proj")

        layer: Dict[str, Any] = {
            "input_layernorm": _norm(sd, f"{pre}.input_layernorm"),
            "post_attention_layernorm": _norm(
                sd, f"{pre}.post_attention_layernorm"
            ),
            "self_attn": attn,
        }

        is_moe = (
            cfg.moe is not None
            and i >= cfg.first_k_dense_replace
            and i % cfg.moe_layer_freq == 0
        )
        if is_moe:
            e = cfg.moe.n_routed_experts
            moe: Dict[str, Any] = {
                "router_weight": _np(sd[f"{pre}.mlp.gate.weight"]),
                "e_score_correction_bias": _np(
                    sd[f"{pre}.mlp.gate.e_score_correction_bias"]
                )
                if f"{pre}.mlp.gate.e_score_correction_bias" in sd
                else np.zeros((e,), np.float32),
                # torch per-expert (F, D) / (D, F) → stacked (E, D, F) / (E, F, D)
                "w_gate": np.stack(
                    [
                        _np(sd[f"{pre}.mlp.experts.{j}.gate_proj.weight"]).T
                        for j in range(e)
                    ]
                ),
                "w_up": np.stack(
                    [
                        _np(sd[f"{pre}.mlp.experts.{j}.up_proj.weight"]).T
                        for j in range(e)
                    ]
                ),
                "w_down": np.stack(
                    [
                        _np(sd[f"{pre}.mlp.experts.{j}.down_proj.weight"]).T
                        for j in range(e)
                    ]
                ),
            }
            if cfg.moe.n_shared_experts:
                moe["shared_experts"] = _swiglu(sd, f"{pre}.mlp.shared_experts")
            layer["moe"] = moe
        else:
            layer["mlp"] = _swiglu(sd, f"{pre}.mlp")
        model[f"layer_{i}"] = layer

    params["model"] = model
    if not tie_embeddings:
        if "lm_head.weight" in sd:
            params["lm_head"] = {"kernel": _np(sd["lm_head.weight"]).T}
        else:  # tied checkpoint loaded untied
            params["lm_head"] = {
                "kernel": _np(sd["model.embed_tokens.weight"]).T
            }
    return params


def load_hf_model(path: str, hf_config: Optional[Any] = None, *,
                  device="cuda", param_dtype=None, compute_dtype=None):
    """A checkpoint (see :func:`load_hf_checkpoint`) as the port's
    ``DeepSeekForCausalLM`` on ``device`` (untied LM head). Returns
    (model, block config, vocab size)."""
    import torch

    from ..convert import load_flax_params
    from .deepseek import DeepSeekForCausalLM

    params, cfg, vocab = load_hf_checkpoint(path, hf_config)
    model = DeepSeekForCausalLM(
        cfg, vocab, generator=torch.Generator(device=device).manual_seed(0),
        device=device, tie_embeddings=False,
        compute_dtype=compute_dtype or torch.float32,
        param_dtype=param_dtype or torch.float32)
    load_flax_params(model, params)
    return model, cfg, vocab


def load_hf_checkpoint(
    path: str, hf_config: Optional[Any] = None, tie_embeddings: bool = False
) -> Tuple[Dict[str, Any], DeepSeekBlockConfig, int]:
    """Load a torch/safetensors DeepSeek checkpoint directory or file.

    Returns (flax_params, block_config, vocab_size).
    """
    import json
    import os

    sd: Dict[str, Any] = {}
    if os.path.isdir(path):
        if hf_config is None:
            with open(os.path.join(path, "config.json")) as f:
                hf_config = json.load(f)
        names = sorted(os.listdir(path))
        for n in names:
            full = os.path.join(path, n)
            if n.endswith(".safetensors"):
                from ..utils.checkpoint_files import read_safetensors

                sd.update(read_safetensors(full))
            elif n.endswith((".bin", ".pt", ".pth")):
                import torch

                sd.update(torch.load(full, map_location="cpu", weights_only=True))
    else:
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
    if hf_config is None:
        raise ValueError("hf_config required when loading a bare state file")
    cfg, vocab = config_from_hf(hf_config)
    return convert_hf_state_dict(sd, cfg, tie_embeddings), cfg, vocab
