"""DeepSeek-style components, PyTorch port of
``deepearth_tpu/models/deepseek.py``: MLA attention, the SwiGLU MLP, the
MoE layer and its dispatch rule, the decoder block, the sequential stack,
the causal LM over it (token decoding: ``models/generation.py``) and the
pooled sequence classifier.

MLA attention over at least ``flash_min_seq`` tokens (with
``use_flash_attention``) runs the flash kernels K4-fwd/K4-bwd on the card,
as the JAX package runs its library flash kernel on the TPU; on the CPU it
stays on ``dot_product_attention``, as the JAX package does there. An MoE
layer's ``auto`` dispatch takes the ragged path (the grouped matmul K5) on
the card where the JAX package takes it on the TPU, and ``scatter`` on the
CPU, as the JAX package does there. Ring attention needs a device mesh,
which the port has none of: a config's ``sequence_axis`` and
``ring_min_seq`` are read and ignored, as the JAX package ignores them where
no mesh is set. Pipelined stages (``pipeline_stages > 1``) are not ported
and raise (ROADMAP.md Queue 1, item 15).

Activation checkpointing (:func:`remat_wrap`, the JAX package's ``nn.remat``
with its three policies) wraps one block at a time: the stack's blocks
here, a fusion stack's layers in ``models/fusion.py``.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..configs import DeepSeekBlockConfig, MLAConfig, MoEConfig
from ..ops import flash_attention as flash
from ..ops import moe as moe_ops
from ..ops import remat as remat_sites
from ..ops.attention import dot_product_attention
from ..ops.norms import RMSNorm
from ..ops.rope import apply_rope_deepseek, rope_tables, yarn_get_mscale
from .layers import Dense, Embed, Init, dropout

FLASH_SHAPE = (
    "MLA attention over {n} >= flash_min_seq={m} tokens runs the flash "
    "kernel K4 on the card, which takes head dims up to {most}, not Dqk "
    "{qh} and Dv {vh}")
PIPELINE_TODO = ("pipelined DeepSeek stacks (pipeline_stages > 1) are not "
                 "ported yet (ROADMAP.md Queue 1, item 15)")

_aten = torch.ops.aten
# the outputs each dots policy keeps: matmuls without batch dims (JAX's
# dots_with_no_batch_dims_saveable), and with them the batched ones
# (dots_saveable)
_SAVED_BY_POLICY = {
    "dots": frozenset({_aten.mm.default, _aten.addmm.default}),
    "dots_saveable": frozenset({_aten.mm.default, _aten.addmm.default,
                                _aten.bmm.default, _aten.baddbmm.default}),
}


def remat_context_fn(policy: Optional[str] = "full") -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
    name: None for 'full' (and None or ''), which recomputes the whole
    block; for 'dots' and 'dots_saveable' selective checkpointing that saves
    the outputs of the policy's matmul ops and recomputes every other op,
    and every op a hand-written kernel's forward runs (``ops.remat``'s
    kernel sites: a Pallas call is not a dot in JAX either). Any other name
    raises JAX's ``ValueError``."""
    if policy in (None, "", "full"):
        return None
    if policy not in _SAVED_BY_POLICY:
        raise ValueError(
            f"unknown remat policy {policy!r}; want full|dots|dots_saveable")
    saved = _SAVED_BY_POLICY[policy]
    CheckpointPolicy = torch_checkpoint.CheckpointPolicy

    def policy_fn(ctx, op, *args, **kwargs):
        if op in saved and not remat_sites.in_kernel_site():
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, policy_fn)


def remat_wrap(module: nn.Module, policy: Optional[str] = "full"
               ) -> Callable:
    """``module`` under activation checkpointing with a named policy, the
    JAX package's ``remat_wrap`` (``nn.remat``): the returned callable takes
    the module's arguments, with ``generator`` as a keyword.

    'full' recomputes the whole block in the backward; 'dots' keeps the
    outputs of matmuls without batch dims and recomputes the rest;
    'dots_saveable' also keeps the batched ones (:func:`remat_context_fn`).
    ``torch.utils.checkpoint`` runs non-reentrant: tensors that leave the
    block by a side channel (an MoE layer's ``aux_loss``) keep their graph.

    Dropout draws its masks from ``generator``, which the checkpoint does
    not restore. The forward draws from it as without remat; the recompute
    draws from a copy set to its state at the block's entry, so it sees the
    forward's masks and the caller's generator ends as without remat.
    Without grad mode the block just runs.
    """
    context_fn = remat_context_fn(policy)
    extra = {} if context_fn is None else {"context_fn": context_fn}

    def run(*args, generator: Optional[torch.Generator] = None, **kwargs):
        if not torch.is_grad_enabled():
            return module(*args, generator=generator, **kwargs)
        entry_state = None if generator is None else generator.get_state()
        calls = [0]

        def block(*a, **kw):
            calls[0] += 1
            if calls[0] == 1:
                return module(*a, generator=generator, **kw)
            replay = None
            if generator is not None:
                replay = torch.Generator(device=generator.device)
                replay.set_state(entry_state)
            with remat_sites.recomputing():
                return module(*a, generator=replay, **kw)
        return torch_checkpoint.checkpoint(block, *args, use_reentrant=False,
                                           **extra, **kwargs)
    return run


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


def dense_all_activation_bytes(cfg: MoEConfig, n_tokens: int,
                               itemsize: int = 2) -> int:
    """The JAX package's reckoning of dense_all's live (E, S, F)-class
    buffers under grad: 4 of E S F plus one of E S D."""
    E, F_, D = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_dim
    return itemsize * (4 * E * n_tokens * F_ + E * n_tokens * D)


def dense_all_budget_bytes(cfg: MoEConfig, device,
                           total_memory: Optional[int] = None) -> int:
    """Activation budget for dense_all, from the config and the device type
    alone: ``cfg.dense_all_max_bytes`` if set; on a card 37.5% of its total
    memory (``total_memory``, else the card's own), at least 256 MiB; 6 GiB
    on the CPU (the JAX package's value where the backend gives no memory
    stats). Never the free or allocated memory: the dispatch algorithm, and
    so which tokens are dropped, must not depend on what else is resident."""
    if cfg.dense_all_max_bytes is not None:
        return int(cfg.dense_all_max_bytes)
    device = torch.device(device)
    if device.type != "cuda":
        return 6 * 2 ** 30
    if total_memory is None:
        total_memory = torch.cuda.get_device_properties(device).total_memory
    return max(int(0.375 * total_memory), 256 * 2 ** 20)


def select_dispatch_mode(cfg: MoEConfig, n_tokens: int, device="cpu",
                         total_memory: Optional[int] = None) -> str:
    """Resolve ``dispatch_mode='auto'`` for a token count, the JAX package's
    rule with the card in the TPU's place.

    ``dense_all`` while E is within ~1.1 capacity_factor K of the routed
    minimum (always for exact mode) and its activations fit the budget;
    else ``dense`` (one-hot capacity dispatch) while S E C <= 2^22; else
    ``ragged`` (drop-free, the grouped matmul K5) on a card when
    ``allow_ragged``; else ``scatter``.
    """
    E, K = cfg.n_routed_experts, cfg.num_experts_per_tok
    S = n_tokens
    flops_ok = (cfg.capacity_factor is None
                or E <= math.ceil(1.1 * cfg.capacity_factor * K))
    if flops_ok and dense_all_activation_bytes(cfg, S) <= \
            dense_all_budget_bytes(cfg, device, total_memory):
        return "dense_all"
    if S * E * capacity(cfg, S) <= 2 ** 22:
        return "dense"
    if cfg.allow_ragged and torch.device(device).type == "cuda":
        return "ragged"
    return "scatter"


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert of the capacity modes: S K when drop-free
    (capacity_factor None), else max(K, ceil(S K / E * capacity_factor))."""
    K = cfg.num_experts_per_tok
    if cfg.capacity_factor is None:
        return n_tokens * K
    return max(K, int(math.ceil(n_tokens * K / cfg.n_routed_experts
                                * cfg.capacity_factor)))


class MoELayer(nn.Module):
    """Routed experts (stacked (E, D, F) weights) plus optional shared
    experts. The router's weight and bias stay float32 whatever the
    parameter type, as in the JAX package.

    After each call the layer keeps, where a caller can read them (flax
    sows the first two, as ``moe_aux_loss`` and ``moe_load``): ``aux_loss``,
    the load-balance loss, differentiable through the router's scores;
    ``load``, the (E,) tokens routed per expert; ``mode``, the dispatch mode
    it took. :func:`collect_moe_aux_losses` gathers ``aux_loss`` over every
    call of a forward.
    """

    def __init__(self, cfg: MoEConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        E, D, F_ = (cfg.n_routed_experts, cfg.hidden_dim,
                    cfg.moe_intermediate_size)
        # kaiming_uniform(a=sqrt(5)) over (E, D)
        bound = math.sqrt(3.0) * math.sqrt(2.0 / 6.0) / math.sqrt(D)
        self.router_weight = nn.Parameter(
            init.empty((E, D), torch.float32).uniform_(
                -bound, bound, generator=init.generator))
        self.e_score_correction_bias = nn.Parameter(
            init.empty((E,), torch.float32).zero_())
        self.w_gate = init.normal((E, D, F_))
        self.w_up = init.normal((E, D, F_))
        self.w_down = init.normal((E, F_, D))
        if cfg.n_shared_experts:
            self.shared_experts = SwiGLUMLP(D, F_ * cfg.n_shared_experts,
                                            init, compute_dtype)
        self.aux_loss = self.load = self.mode = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.cfg, self.compute_dtype
        xf = x.reshape(-1, x.shape[-1])
        S = xf.shape[0]
        gate = moe_ops.moe_gate(
            xf.float() @ self.router_weight.T, self.e_score_correction_bias,
            top_k=cfg.num_experts_per_tok, n_group=cfg.n_group,
            topk_group=cfg.topk_group, norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor)
        mode = cfg.dispatch_mode
        if mode == "auto":
            mode = select_dispatch_mode(cfg, S, xf.device)
        xc = xf.to(cd)
        weights = [w.to(cd) for w in (self.w_gate, self.w_up, self.w_down)]
        if mode == "dense_all":
            y, load = moe_ops.dense_all_expert_ffn(
                xc, gate.topk_idx, gate.topk_weight, *weights)
        elif mode == "ragged":
            y = moe_ops.ragged_expert_ffn(xc, gate.topk_idx,
                                          gate.topk_weight, *weights)
            load = moe_ops.expert_load(gate.topk_idx, cfg.n_routed_experts)
        elif mode == "scatter":
            y, load = moe_ops.scatter_dispatch_ffn(
                xc, gate.topk_idx, gate.topk_weight, *weights,
                capacity(cfg, S))
        elif mode == "dense":
            dispatch, combine, load = moe_ops.make_dispatch_combine(
                gate.topk_idx, gate.topk_weight,
                n_experts=cfg.n_routed_experts, capacity=capacity(cfg, S))
            expert_in = torch.einsum("sec,sd->ecd", dispatch.to(cd), xc)
            expert_out = moe_ops.expert_ffn(expert_in, *weights)
            y = torch.einsum("sec,ecd->sd", combine.to(cd), expert_out)
        else:
            raise ValueError(f"unknown dispatch_mode {mode!r}")
        if cfg.n_shared_experts:
            y = y + self.shared_experts(xf)
        aux_loss = moe_ops.load_balance_aux_loss(
            gate.scores, gate.topk_idx, cfg.n_routed_experts)
        if not remat_sites.is_recomputing():  # keep the forward's values
            self.aux_loss, self.load, self.mode = aux_loss, load, mode
        return y.reshape(x.shape).to(x.dtype)


@contextlib.contextmanager
def collect_moe_aux_losses(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Inside, every call of a :class:`MoELayer` of ``model`` appends its
    ``aux_loss`` to the yielded list, in call order: the values flax sows
    as ``moe_aux_loss``, one per call. A checkpointed block's recompute in a
    backward run inside appends nothing."""
    values: List[torch.Tensor] = []

    def keep(mod, args, out):
        if not remat_sites.is_recomputing():
            values.append(mod.aux_loss)
    hooks = [m.register_forward_hook(keep)
             for m in model.modules() if isinstance(m, MoELayer)]
    try:
        yield values
    finally:
        for h in hooks:
            h.remove()


def layer_uses_moe(cfg: DeepSeekBlockConfig, i: int) -> bool:
    return (cfg.moe is not None and i >= cfg.first_k_dense_replace
            and i % cfg.moe_layer_freq == 0)


class DeepSeekBlock(nn.Module):
    """Pre-RMSNorm decoder block: MLA + (dense SwiGLU | MoE) MLP. Which one
    follows the layer's place in the stack (``first_k_dense_replace``,
    ``moe_layer_freq``) unless ``force_moe`` says."""

    def __init__(self, cfg: DeepSeekBlockConfig, layer_idx: int, init: Init,
                 compute_dtype: torch.dtype,
                 force_moe: Optional[bool] = None):
        super().__init__()
        use_moe = (layer_uses_moe(cfg, layer_idx) if force_moe is None
                   else force_moe)
        dev = init.device
        self.input_layernorm = RMSNorm(cfg.hidden_dim, cfg.rms_norm_eps,
                                       device=dev)
        self.self_attn = MLAttention(cfg.mla, init, compute_dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_dim,
                                                cfg.rms_norm_eps, device=dev)
        if use_moe:
            self.moe = MoELayer(cfg.moe, init, compute_dtype)
        else:
            self.mlp = SwiGLUMLP(cfg.hidden_dim, cfg.intermediate_size, init,
                                 compute_dtype)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                is_causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), key_mask, is_causal,
                               generator)
        h = self.post_attention_layernorm(x)
        return x + (self.moe(h) if hasattr(self, "moe") else self.mlp(h))


class DeepSeekTransformer(nn.Module):
    """``n_layers`` decoder blocks and a final RMSNorm, run in sequence;
    with ``remat`` each block under :func:`remat_wrap` with
    ``remat_policy`` (both plain attributes, read at every forward)."""

    def __init__(self, cfg: DeepSeekBlockConfig, init: Init,
                 compute_dtype: torch.dtype, *, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        if cfg.pipeline_stages and cfg.pipeline_stages > 1:
            raise NotImplementedError(PIPELINE_TODO)
        if remat:
            remat_context_fn(remat_policy)  # an unknown name raises here
        self.remat, self.remat_policy = remat, remat_policy
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
            layer = getattr(self, f"layer_{i}")
            if self.remat:
                layer = remat_wrap(layer, self.remat_policy)
            x = layer(x, key_mask, is_causal, generator=generator)
        return self.norm(x)


class DeepSeekForCausalLM(nn.Module):
    """Token embedding, the DeepSeek stack (causal) and the LM head: the
    embedding's transpose when ``tie_embeddings`` (the default, as in JAX),
    else an ``lm_head`` Dense. Parameters are made in ``param_dtype`` on
    ``device`` (the card unless the caller names another) from
    ``generator``."""

    def __init__(self, cfg: DeepSeekBlockConfig, vocab_size: int, *,
                 generator: torch.Generator, device="cuda",
                 tie_embeddings: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        init = Init(generator, device, param_dtype)
        self.cfg, self.vocab_size = cfg, vocab_size
        self.param_dtype = param_dtype
        self.embed_tokens = Embed(vocab_size, cfg.hidden_dim, init,
                                  compute_dtype)
        self.model = DeepSeekTransformer(cfg, init, compute_dtype)
        if not tie_embeddings:
            self.lm_head = Dense(cfg.hidden_dim, vocab_size, init,
                                 compute_dtype, use_bias=False)

    @property
    def tie_embeddings(self) -> bool:
        return not hasattr(self, "lm_head")

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids (B, S) -> logits (B, S, vocab); attention_mask optional
        (B, S) bool, True = a real token."""
        h = self.model(self.embed_tokens(input_ids), key_mask=attention_mask,
                       is_causal=True, generator=generator)
        if self.tie_embeddings:
            return self.embed_tokens.attend(h.to(self.param_dtype))
        return self.lm_head(h)


class DeepSeekForSequenceClassification(nn.Module):
    """Pooled classifier head over the DeepSeek stack: token ids through an
    embedding (``vocab_size`` set) or (B, S, hidden) features, the stack
    (not causal) with the key mask, the mean over the unmasked positions,
    then the ``score`` Dense (with bias) to ``num_labels`` logits.
    Parameters are made in ``param_dtype`` on ``device`` (the card unless
    the caller names another) from ``generator``."""

    def __init__(self, cfg: DeepSeekBlockConfig, num_labels: int,
                 vocab_size: Optional[int] = None, *,
                 generator: torch.Generator, device="cuda",
                 compute_dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        init = Init(generator, device, param_dtype)
        self.cfg, self.num_labels = cfg, num_labels
        self.compute_dtype = compute_dtype
        if vocab_size is not None:
            self.embed_tokens = Embed(vocab_size, cfg.hidden_dim, init,
                                      compute_dtype)
        self.model = DeepSeekTransformer(cfg, init, compute_dtype)
        self.score = Dense(cfg.hidden_dim, num_labels, init, compute_dtype)

    def forward(self, inputs: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """inputs (B, S) ids or (B, S, hidden) features -> (B, num_labels)
        logits; attention_mask optional (B, S) bool, True = a real
        position."""
        if hasattr(self, "embed_tokens"):
            h = self.embed_tokens(inputs)
        else:
            h = inputs.to(self.compute_dtype)
        h = self.model(h, key_mask=attention_mask, generator=generator)
        if attention_mask is not None:
            w = attention_mask[..., None].to(h.dtype)
            pooled = (h * w).sum(1) / w.sum(1).clamp_min(1.0)
        else:
            pooled = h.mean(dim=1)
        return self.score(pooled)
