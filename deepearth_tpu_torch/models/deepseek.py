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
CPU, as the JAX package does there. Under an ambient mesh
(``ops.sharding.use_mesh``, the part of ``jax.set_mesh``) a config's
``sequence_axis`` runs MLA attention as ring attention over that axis
(``parallel.ring``) where N >= ``ring_min_seq`` divides evenly by its size;
without one it is read and ignored, as in JAX. While each rank holds its
own rows of the batch, an MoE layer chooses its dispatch for the global
batch's token count, as JAX's global program does: on a capacity-free mode
(``ragged``, ``dense_all``) it routes its own tokens and sums the load
statistics of its load-balance loss over 'data'; on a capacity mode it
gathers the tokens over 'data' first. A pipelined stack then runs each
rank's share of every global microbatch.

A stack with ``pipeline_stages = P > 1`` runs its shortest aligning prefix
of layers in sequence, then the rest as P stages of k layers each, their
parameters stacked on a leading stage axis (``pipe.stages.layer_i``, flax's
``pipe/stages/layer_i``), through a GPipe schedule of M + P - 1 ticks
(``parallel.pipeline``): every stage at every tick in one process, as JAX's
``vmap`` over stages; one stage a rank over an ambient mesh's 'pipe'
group.

Activation checkpointing (:func:`remat_wrap`, the JAX package's ``nn.remat``
with its three policies) wraps one block at a time: the stack's blocks
here, a fusion stack's layers in ``models/fusion.py``.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Iterator, List, Optional

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
from ..ops.sharding import ambient_mesh, data_rows_group, expert_split, \
    rows_local, shard_hint, use_mesh
from ..parallel import comm
from .layers import Dense, Embed, Init, dropout

FLASH_SHAPE = (
    "MLA attention over {n} >= flash_min_seq={m} tokens runs the flash "
    "kernel K4 on the card, which takes head dims up to {most}, not Dqk "
    "{qh} and Dv {vh}")

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
        ring_mesh = self._ring_mesh(N)
        use_flash = (ring_mesh is None and cfg.use_flash_attention
                     and N >= cfg.flash_min_seq
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
        # (B, H, N, Dh): batch over 'data', heads over 'model' in JAX's
        # layout rule
        query = shard_hint(torch.cat([q_nope, q_pe], dim=-1), "data",
                           "model")
        key = shard_hint(torch.cat([k_nope, k_pe.expand(B, H, N, rope_d)],
                                   dim=-1), "data", "model")
        v = shard_hint(v, "data", "model")

        scale = qh ** -0.5
        rs = cfg.rope_scaling
        if rs.type == "yarn" and rs.mscale_all_dim:
            ms = yarn_get_mscale(rs.factor, rs.mscale_all_dim)
            scale = scale * ms * ms

        if ring_mesh is not None:
            from ..parallel.ring import ring_attention

            ba = cfg.ring_batch_axis
            # rows split over 'data' already are not split again
            batch_axis = (ba if not rows_local() and ba in ring_mesh.shape
                          and B % ring_mesh.shape[ba] == 0 else None)
            out = ring_attention(
                query, key.to(query.dtype), v.to(query.dtype), scale=scale,
                mesh=ring_mesh, axis_name=cfg.sequence_axis,
                key_mask=key_mask, is_causal=is_causal,
                batch_axis=batch_axis).to(v.dtype)
        elif use_flash:
            out = flash.flash_attention(
                query, key.to(query.dtype), v.to(query.dtype), scale=scale,
                key_mask=key_mask, causal=is_causal).to(v.dtype)
        else:
            out = dot_product_attention(query, key, v, scale=scale,
                                        key_mask=key_mask,
                                        is_causal=is_causal)
        out = self.o_proj(out.transpose(1, 2).reshape(B, N, H * vh))
        return dropout(out, cfg.attention_dropout, self.training, generator)

    def _ring_mesh(self, n: int):
        """The ambient mesh when ring attention applies: ``sequence_axis``
        a mesh axis of size > 1 dividing N, and N >= ``ring_min_seq``.
        A pure function of (config, mesh), the same on every rank."""
        cfg = self.cfg
        if cfg.sequence_axis is None or n < cfg.ring_min_seq:
            return None
        mesh = ambient_mesh()
        if mesh is None:
            return None
        size = mesh.shape.get(cfg.sequence_axis, 1)
        return mesh if size > 1 and n % size == 0 else None


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
    it took; ``experts``, (the first, the count) of the experts it ran.
    :func:`collect_moe_aux_losses` gathers ``aux_loss`` over every call of
    a forward.

    Under an ambient mesh whose 'expert' axis has more than one rank and
    divides E (``ops.sharding.expert_split``), the layer runs only this
    rank's block of E / ranks experts (the block of the weights that the
    'expert' rule gives it), on every token it routes: the gate sees all E
    experts, the route (``dense_all``, ``scatter`` or ``dense``; ``ragged``
    raises) keeps the whole routing's slots and runs the block's, and the
    blocks' outputs are summed over 'expert' (the backward passes the
    gradient on); the tokens and the gate weights enter through
    ``comm.split_inputs``, so their gradients, and every weight's before
    the experts, are whole and alike on the axis's ranks. The load
    statistics and the aux loss see every expert.
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
        self.aux_loss = self.load = self.mode = self.experts = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.cfg, self.compute_dtype
        E = cfg.n_routed_experts
        x_local = x.reshape(-1, x.shape[-1])
        # rows split over 'data': the mode is chosen for the global batch's
        # token count, as JAX's global program chooses it. ragged and
        # dense_all route each token alone, so each rank routes its own and
        # only the load statistics are summed over 'data'; the capacity
        # modes' slots follow the global token order, so they route the
        # gathered tokens (the ranks' in turn)
        group = data_rows_group()
        n_ranks = comm.group_size(group)
        mode = cfg.dispatch_mode
        if mode == "auto":
            mode = select_dispatch_mode(cfg, x_local.shape[0] * n_ranks,
                                        x_local.device)
        gathered = n_ranks > 1 and mode in ("scatter", "dense")
        xf = comm.gather_rows(x_local, group) if gathered else x_local
        S = xf.shape[0]
        gate = moe_ops.moe_gate(
            xf.float() @ self.router_weight.T, self.e_score_correction_bias,
            top_k=cfg.num_experts_per_tok, n_group=cfg.n_group,
            topk_group=cfg.topk_group, norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor)
        xc = xf.to(cd)
        topk_weight = gate.topk_weight
        weights = [w.to(cd) for w in (self.w_gate, self.w_up, self.w_down)]
        # experts over 'expert': this rank runs its block of them on every
        # token it routes, and the blocks' outputs are added over the axis
        split = expert_split(E)
        first, n_mine, reduce = 0, E, None
        if split is not None:
            ep, first, n_mine = split
            if mode == "ragged":
                raise ValueError("the ragged dispatch has no expert-parallel "
                                 "layout: DistributedTrainer demotes it "
                                 "under an 'expert' axis")
            weights = [self._experts_of(w, first, n_mine) for w in weights]
            xc = comm.split_inputs(xc, ep)
            topk_weight = comm.split_inputs(topk_weight, ep)

            def reduce(y, ep=ep):
                return comm.all_reduce_replicated(y, ep)
        block = dict(first_expert=first, n_experts=E, reduce=reduce)
        if mode == "dense_all":
            y, load = moe_ops.dense_all_expert_ffn(
                xc, gate.topk_idx, topk_weight, *weights, **block)
        elif mode == "ragged":
            y = moe_ops.ragged_expert_ffn(xc, gate.topk_idx, topk_weight,
                                          *weights)
            load = moe_ops.expert_load(gate.topk_idx, E)
        elif mode == "scatter":
            y, load = moe_ops.scatter_dispatch_ffn(
                xc, gate.topk_idx, topk_weight, *weights, capacity(cfg, S),
                **block)
        elif mode == "dense":
            dispatch, combine, load = moe_ops.make_dispatch_combine(
                gate.topk_idx, topk_weight, n_experts=E,
                capacity=capacity(cfg, S))
            mine = slice(first, first + n_mine)
            expert_in = torch.einsum("sec,sd->ecd",
                                     dispatch[:, mine].to(cd), xc)
            expert_out = moe_ops.expert_ffn(expert_in, *weights)
            y = torch.einsum("sec,ecd->sd", combine[:, mine].to(cd),
                             expert_out)
            if reduce is not None:
                y = reduce(y.float()).to(cd)
        else:
            raise ValueError(f"unknown dispatch_mode {mode!r}")
        if gathered:
            n = x_local.shape[0]
            y = y[comm.group_rank(group) * n:][:n]
        if cfg.n_shared_experts:
            y = y + self.shared_experts(x_local)
        if n_ranks > 1 and not gathered:
            counts, probs = moe_ops.load_balance_sums(gate.scores,
                                                      gate.topk_idx, E)
            load = comm.all_reduce_rows(counts, group)
            probs = comm.all_reduce_rows(probs, group)
            total = S * n_ranks
            aux_loss = E * torch.sum(load / total * (probs / total))
        else:
            aux_loss = moe_ops.load_balance_aux_loss(gate.scores,
                                                     gate.topk_idx, E)
        if not remat_sites.is_recomputing():  # keep the forward's values
            self.aux_loss, self.load, self.mode = aux_loss, load, mode
            self.experts = (first, n_mine)
        return y.reshape(x.shape).to(x.dtype)

    def _experts_of(self, w: torch.Tensor, first: int, n: int
                    ) -> torch.Tensor:
        """Experts [first, first + n) of a stacked expert weight: the
        weight itself where it holds only those (this rank's block under
        the 'expert' rule), else its slice."""
        E = self.cfg.n_routed_experts
        if w.shape[0] == n:
            return w
        if w.shape[0] == E:
            return w[first:first + n]
        raise ValueError(f"expert weight of {w.shape[0]} experts: want {E}, "
                         f"or this rank's {n}")


@contextlib.contextmanager
def collect_moe_aux_losses(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Inside, every call of a :class:`MoELayer` of ``model`` appends its
    ``aux_loss`` to the yielded list, in call order: the values flax sows
    as ``moe_aux_loss``, one per call; a pipelined stack appends one term
    per MoE layer of its stages (:class:`PipelineStages`). A checkpointed
    block's recompute in a backward run inside appends nothing."""
    values: List[torch.Tensor] = []

    def keep(mod, args, out):
        if not remat_sites.is_recomputing():
            values.append(mod.aux_loss)

    def keep_pipelined(mod, args, out):
        values.extend(mod.moe_aux_terms)
    hooks = [m.register_forward_hook(keep)
             for m in model.modules() if isinstance(m, MoELayer)]
    hooks += [m.register_forward_hook(keep_pipelined)
              for m in model.modules() if isinstance(m, PipelineStages)]
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


def pipeline_split(cfg: DeepSeekBlockConfig, n_stages: int):
    """The smallest sequential prefix p such that layers p..n_layers split
    into ``n_stages`` equal stages with one dense / MoE pattern (stacked
    stage parameters need one structure); returns (p, the pattern). The
    flagship (24 layers, first_k_dense_replace=1, 4 stages) gives p = 4.
    Raises ``ValueError`` where no prefix aligns, as JAX does."""
    for p in range(cfg.n_layers - n_stages + 1):
        rem = cfg.n_layers - p
        if rem % n_stages:
            continue
        k = rem // n_stages
        pats = [tuple(layer_uses_moe(cfg, p + s * k + i) for i in range(k))
                for s in range(n_stages)]
        if all(q == pats[0] for q in pats):
            return p, pats[0]
    raise ValueError(
        f"no prefix split of {cfg.n_layers} layers into {n_stages} uniform "
        f"pipeline stages (first_k_dense_replace={cfg.first_k_dense_replace},"
        f" moe_layer_freq={cfg.moe_layer_freq})")


def _stacked_tree(template: nn.Module, blocks: List[nn.Module]) -> nn.Module:
    """A module tree shaped as ``template`` whose parameters are those of
    ``blocks`` stacked on a leading axis; each node keeps the template
    node's type as ``flax_type`` (convert.py names its leaves by it)."""
    holder = nn.Module()
    holder.flax_type = type(template)
    for name, _ in template.named_parameters(recurse=False):
        holder.register_parameter(name, nn.Parameter(torch.stack(
            [getattr(b, name).detach() for b in blocks])))
    for name, child in template.named_children():
        holder.add_module(name, _stacked_tree(
            child, [getattr(b, name) for b in blocks]))
    return holder


class PipelineStages(nn.Module):
    """The pipelined part of a stack (flax's ``pipe``): ``stages.layer_i``
    holds layer i of every stage, its parameters stacked on a leading
    stage axis of size P, and runs them through the GPipe schedule.

    Each MoE layer of a stage adds one term to the load-balance loss, the
    mean over (tick, stage) of its calls, bubble ticks included: the value
    flax sows through ``nn.scan`` and ``nn.vmap`` (``moe_aux_terms``, read
    by :func:`collect_moe_aux_losses`)."""

    def __init__(self, cfg: DeepSeekBlockConfig, pattern, n_stages: int,
                 init: Init, compute_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.pattern, self.n_stages = cfg, tuple(pattern), n_stages
        self.stages = nn.Module()
        templates = []
        for i, use_moe in enumerate(self.pattern):
            blocks = [DeepSeekBlock(cfg, i, init, compute_dtype,
                                    force_moe=bool(use_moe))
                      for _ in range(n_stages)]
            self.stages.add_module(f"layer_{i}",
                                   _stacked_tree(blocks[0], blocks))
            templates.append(blocks[0].to("meta"))
        # the blocks that run each stage's slice of the stacked parameters
        # (torch.func.functional_call); kept out of the module tree
        self.__dict__["_templates"] = templates
        self.moe_aux_terms: List[torch.Tensor] = []

    def _param_names(self, i: int) -> List[str]:
        return [n for n, _ in getattr(self.stages,
                                      f"layer_{i}").named_parameters()]

    def stage_params(self, s: int) -> List[torch.Tensor]:
        """Stage s's parameter slices, layer by layer, in
        :meth:`_param_names` order."""
        return [p[s] for i in range(len(self.pattern))
                for p in getattr(self.stages, f"layer_{i}").parameters()]

    def _run_stage(self, params, x, mask, is_causal, generator, remat,
                   remat_policy, mesh, rows_local):
        """One stage (its k blocks) on one microbatch; returns (y, the
        MoE layers' aux losses as a (k,) fp32 vector)."""
        aux = []
        it = iter(params)
        for i, template in enumerate(self._templates):
            names = self._param_names(i)
            named = {n: next(it) for n in names}
            template.train(self.training)

            def block(a, m, causal, generator=None, _t=template, _p=named):
                # rows_local: this rank's share of a global microbatch;
                # else the global microbatch whole; alike in the forward
                # and in any recompute
                with use_mesh(mesh, rows_local=rows_local):
                    return torch.func.functional_call(
                        _t, _p, (a, m, causal), {"generator": generator})
            fn = remat_wrap(block, remat_policy) if remat else block
            x = fn(x, mask, is_causal, generator=generator)
            aux.append(template.moe.aux_loss.float() if hasattr(
                template, "moe") else torch.zeros((), device=x.device))
        return x, torch.stack(aux)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                is_causal: bool, generator: Optional[torch.Generator],
                remat: bool = False, remat_policy: str = "full"
                ) -> torch.Tensor:
        """With the rows split over 'data' (n ranks), JAX's microbatches
        are the global batch's: where each holds a multiple of n rows,
        every rank runs its share of each (``comm.rows_to_shares``), the MoE
        layers summing their statistics over 'data' per call; else every
        rank runs the gathered batch whole."""
        from ..parallel import pipeline

        cfg, P = self.cfg, self.n_stages
        mesh = ambient_mesh()
        rows = data_rows_group()
        n_ranks = comm.group_size(rows)
        n_local, N, D = x.shape
        B = n_local * n_ranks
        m = cfg.pipeline_microbatches
        if not m:
            m = min(4 * P, B)
            while B % m:
                m -= 1
        if B % m:
            raise ValueError(f"batch {B} % microbatches {m} != 0")
        shares = (B // m) % n_ranks == 0
        if shares:
            x = comm.rows_to_shares(x, rows, m)
            if key_mask is not None:
                key_mask = comm.rows_to_shares(key_mask, rows, m)
        else:
            x = comm.gather_rows(x, rows)
            if key_mask is not None:
                key_mask = comm.gather_rows(key_mask, rows)
        mb = x.shape[0] // m
        x_mb = x.reshape(m, mb, N, D)
        mask_mb = (key_mask.reshape(m, mb, N)
                   if key_mask is not None else None)
        pipe = mesh.group("pipe") if mesh is not None else None
        run = functools.partial(self._run_stage, is_causal=is_causal,
                                remat=remat, remat_policy=remat_policy,
                                mesh=mesh, rows_local=shares and n_ranks > 1)
        if pipe is None:
            out_mb, aux = pipeline.gpipe_local(
                lambda s, a, mk: run(self.stage_params(s), a, mk,
                                     generator=generator),
                P, x_mb, mask_mb)
        else:
            if mesh.shape["pipe"] != P:
                raise ValueError(f"pipeline_stages {P} != the mesh's 'pipe' "
                                 f"size {mesh.shape['pipe']}")
            me = comm.group_rank(pipe)
            out_mb, aux = pipeline.gpipe_group(
                lambda a, mk, params, gen: run(params, a, mk, generator=gen),
                self.stage_params(me), x_mb, mask_mb, pipe, generator,
                n_aux=len(self.pattern))
            aux = comm.all_reduce_replicated(aux, pipe)
        ticks = m + P - 1
        self.moe_aux_terms = [aux[i] / (ticks * P)
                              for i, use in enumerate(self.pattern) if use]
        out = out_mb.reshape(m * mb, N, D)
        if shares:
            return comm.shares_to_rows(out, rows, m)
        return out[comm.group_rank(rows) * n_local:][:n_local]


class DeepSeekTransformer(nn.Module):
    """``n_layers`` decoder blocks and a final RMSNorm, run in sequence;
    with ``remat`` each block under :func:`remat_wrap` with
    ``remat_policy`` (both plain attributes, read at every forward).

    With ``pipeline_stages = P > 1`` the layers after
    :func:`pipeline_split`'s prefix run as P pipeline stages
    (:class:`PipelineStages`, ``self.pipe``); the output equals the
    sequential stack's on the same weights."""

    def __init__(self, cfg: DeepSeekBlockConfig, init: Init,
                 compute_dtype: torch.dtype, *, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        if remat:
            remat_context_fn(remat_policy)  # an unknown name raises here
        self.remat, self.remat_policy = remat, remat_policy
        self.n_layers = cfg.n_layers
        pattern = None
        if cfg.pipeline_stages and cfg.pipeline_stages > 1:
            self.n_layers, pattern = pipeline_split(cfg, cfg.pipeline_stages)
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}",
                            DeepSeekBlock(cfg, i, init, compute_dtype))
        if pattern is not None:
            self.pipe = PipelineStages(cfg, pattern, cfg.pipeline_stages,
                                       init, compute_dtype)
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
        if hasattr(self, "pipe"):
            x = self.pipe(x, key_mask, is_causal, generator, self.remat,
                          self.remat_policy)
        return self.norm(x)


def stack_sequential_state(state: Dict[str, torch.Tensor],
                           cfg: DeepSeekBlockConfig
                           ) -> Dict[str, torch.Tensor]:
    """A sequential stack's state dict (``layer_j.*``, ``norm.*``) as the
    pipelined stack's of ``cfg`` (``cfg.pipeline_stages`` stages): the
    prefix layers as they are, stage s's layer i from layer
    prefix + s k + i, stacked (``parallel.stack_stage_params``)."""
    from ..parallel.pipeline import stack_stage_params

    P = cfg.pipeline_stages
    prefix, pattern = pipeline_split(cfg, P)
    k = len(pattern)
    out = {n: v for n, v in state.items()
           if not n.startswith("layer_")
           or int(n.split(".")[0][6:]) < prefix}
    for i in range(k):
        per_stage = []
        for s in range(P):
            head = f"layer_{prefix + s * k + i}."
            per_stage.append({n[len(head):]: v for n, v in state.items()
                              if n.startswith(head)})
        for n, v in stack_stage_params(per_stage).items():
            out[f"pipe.stages.layer_{i}.{n}"] = v
    return out


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
