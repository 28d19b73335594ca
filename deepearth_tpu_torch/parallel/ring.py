"""Ring attention: sequence parallelism over a mesh axis, PyTorch port of
``deepearth_tpu/parallel/ring.py``.

q, k, v come in whole (B, H, N, D) on every rank of the axis (the layout
the rest of the replicated model keeps). Each rank takes its own sequence
block, and the online-softmax recurrence of the JAX package's
``_ring_attention_local`` runs over the k / v blocks as they pass: after
each step k, v and the key mask move one hop around the ring by
point-to-point send / receive, so one block of k / v is resident at a time.
Scores, running max, denominator and numerator are fp32; a row that saw no
visible key on any rank gives zero. The output blocks are then gathered
back into the whole (B, H, N, Dv) on every rank.

``torch.distributed`` send / receive is not differentiable, so the
backward is written out (:class:`_RingAttention`): each rank recomputes
its blocks' probabilities from the saved row max and denominator, and the
dk / dv of a k / v block travel around the ring with it, one more hop
bringing them home: the transpose of JAX's rotation. The gradients are
gathered whole on every rank, as the forward's output is.

``batch_axis`` co-shards the batch over a second axis, as in JAX. Without
a group for ``axis_name`` (an abstract mesh) the ring is one process's
loop over the blocks, with the same arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm

NEG_INF = -1e30  # as ops/attention.py: fully masked rows stay NaN-free


def _block_scores(q, k, key_mask, scale, is_causal, q_pos, k_pos):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if is_causal:
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :])[None, None],
                          NEG_INF)
    return s


def _forward_blocks(q, blocks, scale, is_causal, my, n_shards):
    """The recurrence over the k / v / mask blocks ``blocks`` yields in
    ring order; returns (out fp32, m, l)."""
    b, h, nq, _ = q.shape
    q_pos = my * nq + torch.arange(nq, device=q.device)
    m = l = o = None
    for i, (k, v, key_mask) in enumerate(blocks):
        nk = k.shape[2]
        src = (my - i) % n_shards
        k_pos = src * nk + torch.arange(nk, device=q.device)
        s = _block_scores(q, k, key_mask, scale, is_causal, q_pos, k_pos)
        if m is None:
            m = torch.full((b, h, nq), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros((b, h, nq, v.shape[3]), dtype=torch.float32,
                            device=q.device)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
        m = m_new
    return o, m, l


class _Ring:
    """The blocks of one rank's ring: rotated by send / receive over
    ``group``, or (no group) all of them in one process."""

    def __init__(self, group, n_shards, my):
        self.group, self.n, self.my = group, n_shards, my

    def blocks(self, tensors_of):
        """Yield, for i = 0..n-1, the tensors of the block that started on
        rank my - i; ``tensors_of(j)`` gives rank j's own (no group)."""
        if self.group is None:
            for i in range(self.n):
                yield tensors_of((self.my - i) % self.n)
            return
        cur = tensors_of(self.my)
        for i in range(self.n):
            yield cur
            if i < self.n - 1:
                cur = comm.ring_shift(cur, self.group)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, is_causal, n_shards, group,
                batch_group):
        out, saved = _ring_forward(q, k, v, key_mask, scale, is_causal,
                                   n_shards, group, batch_group)
        ctx.save_for_backward(q, k, v, key_mask, *saved)
        ctx.args = (scale, is_causal, n_shards, group, batch_group)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, *saved = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, key_mask, saved, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _split(x, n, i, dim):
    return x.chunk(n, dim=dim)[i]


def _locals(q, k, v, key_mask, n_shards, group, batch_group):
    nb, ib = comm.group_size(batch_group), comm.group_rank(batch_group)
    my = comm.group_rank(group) if group is not None else None
    q, k, v = (_split(t, nb, ib, 0) for t in (q, k, v))
    key_mask = _split(key_mask, nb, ib, 0)
    return q, k, v, key_mask, my


def _ring_forward(q, k, v, key_mask, scale, is_causal, n_shards, group,
                  batch_group):
    q, k, v, key_mask, my = _locals(q, k, v, key_mask, n_shards, group,
                                    batch_group)
    ranks = [my] if group is not None else range(n_shards)
    outs, saved = [], []
    for r in ranks:
        ring = _Ring(group, n_shards, r)
        qr = _split(q, n_shards, r, 2)
        o, m, l = _forward_blocks(
            qr, ring.blocks(lambda j: (_split(k, n_shards, j, 2),
                                       _split(v, n_shards, j, 2),
                                       _split(key_mask, n_shards, j, 1))),
            scale, is_causal, r, n_shards)
        out = torch.where(m[..., None] > NEG_INF / 2,
                          o / l[..., None].clamp_min(1e-30), 0.0)
        outs.append(out.to(q.dtype))
        saved += [m, l]
    out = outs[0] if group is not None else torch.cat(outs, dim=2)
    out = comm.gather_replicated(out, group, dim=2)
    out = comm.gather_replicated(out, batch_group, dim=0)
    return out, saved


def _ring_backward(q, k, v, key_mask, saved, g, scale, is_causal, n_shards,
                   group, batch_group):
    q, k, v, key_mask, my = _locals(q, k, v, key_mask, n_shards, group,
                                    batch_group)
    nb, ib = comm.group_size(batch_group), comm.group_rank(batch_group)
    g = _split(g, nb, ib, 0)
    ranks = [my] if group is not None else list(range(n_shards))
    dqs = []
    # dk / dv accumulators of every block (one process) or of the block
    # travelling with this rank's ring (one per rank)
    if group is None:
        dks = [torch.zeros(_split(k, n_shards, j, 2).shape,
                           dtype=torch.float32, device=k.device)
               for j in range(n_shards)]
        dvs = [torch.zeros(_split(v, n_shards, j, 2).shape,
                           dtype=torch.float32, device=v.device)
               for j in range(n_shards)]
    for idx, r in enumerate(ranks):
        m, l = saved[2 * idx], saved[2 * idx + 1]
        qr = _split(q, n_shards, r, 2)
        gr = _split(g, n_shards, r, 2).float()
        nq = qr.shape[2]
        # dO of a row that saw no key is dropped (its output is the
        # constant zero)
        gr = torch.where((m > NEG_INF / 2)[..., None], gr, 0.0)
        lse_inv = 1.0 / l.clamp_min(1e-30)
        q_pos = r * nq + torch.arange(nq, device=q.device)
        # delta = rowsum(dO * O), O recomputed in fp32 by a first sweep
        o_acc = None
        blocks = []
        ring = _Ring(group, n_shards, r)
        for i, (kb, vb, mb) in enumerate(ring.blocks(
                lambda j: (_split(k, n_shards, j, 2),
                           _split(v, n_shards, j, 2),
                           _split(key_mask, n_shards, j, 1)))):
            src = (r - i) % n_shards
            k_pos = src * kb.shape[2] + torch.arange(kb.shape[2],
                                                     device=q.device)
            s = _block_scores(qr, kb, mb, scale, is_causal, q_pos, k_pos)
            p = torch.exp(s - m[..., None]) * lse_inv[..., None]
            pv = torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
            o_acc = pv if o_acc is None else o_acc + pv
            blocks.append((src, kb, vb, mb, k_pos))
        delta = (gr * o_acc).sum(dim=-1)
        dq = torch.zeros(qr.shape, dtype=torch.float32, device=q.device)
        dk_t = dv_t = None
        for i, (src, kb, vb, mb, k_pos) in enumerate(blocks):
            s = _block_scores(qr, kb, mb, scale, is_causal, q_pos, k_pos)
            p = torch.exp(s - m[..., None]) * lse_inv[..., None]
            dv_b = torch.einsum("bhqk,bhqd->bhkd", p, gr)
            dp = torch.einsum("bhqd,bhkd->bhqk", gr, vb.float())
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb.float()) * scale
            dk_b = torch.einsum("bhqk,bhqd->bhkd", ds, qr.float()) * scale
            if group is None:
                dks[src] += dk_b
                dvs[src] += dv_b
            else:
                # the accumulators ride with the block: after this step
                # they move on with it (the same hop the forward made)
                dk_t = dk_b if dk_t is None else dk_t + dk_b
                dv_t = dv_b if dv_t is None else dv_t + dv_b
                dk_t, dv_t = comm.ring_shift([dk_t, dv_t], group)
        dqs.append(dq)
    if group is None:
        dq = torch.cat(dqs, dim=2)
        dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    else:
        # n shifts in all bring each block's dk / dv back to its owner
        dq, dk, dv = dqs[0], dk_t, dv_t
    dq, dk, dv = (comm.gather_replicated(t, group, dim=2)
                  for t in (dq, dk, dv))
    dq, dk, dv = (comm.gather_replicated(t, batch_group, dim=0)
                  for t in (dq, dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, mesh, axis_name: str = "sequence",
                   key_mask: Optional[torch.Tensor] = None,
                   is_causal: bool = False,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name`` ring.

    q, k, v: the whole (B, H, N, D) arrays, alike on every rank of the
    axis; N must divide by the axis size, and B by ``batch_axis``'s size
    where given. key_mask: optional (B, N) bool, True = visible. Returns the
    whole (B, H, N, Dv) exact attention (fp32 softmax) on every rank, in
    q's dtype."""
    n_shards = int(mesh.shape[axis_name])
    if q.shape[2] % n_shards or k.shape[2] % n_shards:
        raise ValueError(
            f"sequence dims {q.shape[2]}/{k.shape[2]} must divide the "
            f"'{axis_name}' axis size {n_shards}")
    if batch_axis is not None and q.shape[0] % int(mesh.shape[batch_axis]):
        raise ValueError(
            f"batch {q.shape[0]} must divide the '{batch_axis}' axis size")
    if key_mask is None:
        key_mask = torch.ones((k.shape[0], k.shape[2]), dtype=torch.bool,
                              device=k.device)
    group = mesh.group(axis_name)
    batch_group = mesh.group(batch_axis) if batch_axis is not None else None
    return _RingAttention.apply(q, k, v, key_mask.bool(), float(scale),
                                bool(is_causal), n_shards, group,
                                batch_group)
