"""The tile recurrences of the TMA-route attention kernels, on the CPU.

No CUDA kernel runs here, so each kernel's recurrence is written out tile by
tile in plain PyTorch, as the kernel runs it, and held against the plain
versions the kernels are held to on the card, and against the JAX package's
kernels (interpret mode, as ``tests/test_torch_flash_attention.py`` and
``tests/test_torch_attention_vmem.py`` run them) on the same numpy inputs:

- K4-fwd (``kernels/csrc/flash_attention_fwd_tma.cu``): per key tile of 128,
  scores in fp32 scaled by ``scale log2 e``, the running max and sum, each
  tile's p = exp2(s - m) rounded to v's type before P.V, the output
  rescaled as the max grows and divided by the sum once at the end;
  lse = m ln 2 + log l. Held to ``chip_smoke``'s K4 limits: the largest
  error within ``K4_MAX_REL`` of the plain output's largest entry, the mean
  error within ``K4_MEAN_REL`` of the mean |plain|, lse within
  ``K4_LSE_TOL``.
- K3-bwd's stats sweep (the ``kStats`` dq kernel of
  ``kernels/csrc/flash_attention_bwd_tma.cu``): per key tile of 64 the
  running m, l = sum exp(s - m) and t = sum exp(s - m) dp, rescaled as m
  grows; lse = m + log l and delta = t / l, +inf and 0 where no key is
  seen. In fp32 lse within 1e-6 relative of the plain softmax's, delta
  within 1e-6 of the sum of its terms' magnitudes; the gradients they give
  within 2e-5 of JAX's ``_bwd_kernel``'s largest entry, as the plain
  backward is held.
- K3-fwd (``kernels/csrc/attention_vmem_fwd_tma.cu``): a stats sweep per
  key tile of 64 (the running max m2 of s scale log2 e over the visible
  keys and l = sum exp2(s scale log2 e - m2), rescaled as m2 grows), then an
  output sweep whose p = exp2(s scale log2 e - m2) (1 / l) is rounded to v's
  type before each tile's P.V. Held against JAX's ``_fwd_kernel`` in
  interpret mode and ``vmem_attention_plain``: fp32 within 1e-5 of the
  largest entry, bf16 within ``VMEM_TOL`` (2e-2); a row whose keys are all
  masked exactly 0; a masked key's bias NEG_BIG or -inf giving the same p
  under the guarded softmax (m >= -1e30, l >= 1e-30), and the kernel's own
  guards (-inf biases, m2 = -inf read as 0, 1 / l = 0 where l = 0) the same
  output bit for bit.
"""

import math

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
from deepearth_tpu.ops import attention_vmem as jvmem
from deepearth_tpu_torch.ops import attention_vmem as tvmem
from deepearth_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

# chip_smoke.py's limits for K4-fwd (the card's kernel against its plain
# version); not imported, since chip_smoke needs a card to run
K4_MAX_REL, K4_MEAN_REL, K4_LSE_TOL = 2 ** -6, 2 ** -8, 1e-4
# chip_smoke.py's limit for K3-fwd in bf16 (one ulp at |x| < 4)
VMEM_TOL_BF16 = 2e-2
LOG2E, LN2 = 1.0 / math.log(2.0), math.log(2.0)
FWD_KEYS, BWD_KEYS = 128, 64  # the kernels' key tiles
VMEM_FWD_KEYS = 64  # K3-fwd's key tile


def numpy_inputs(seed, b, h, nq, nk, dqk, dv, mask=False):
    """q, k, v, dout and a key mask whose batch row 0 sees no key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, dqk)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, dqk)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, dv)).astype(np.float32)
    do = rng.standard_normal((b, h, nq, dv)).astype(np.float32)
    key_mask = None
    if mask:
        key_mask = rng.uniform(size=(b, nk)) > 0.3
        key_mask[0] = False
    return q, k, v, do, key_mask


def visible(key_mask, causal, j0, j1, nq, b):
    """(B, 1, Nq, j1 - j0) bool: which keys of the tile each query sees."""
    vis = torch.ones((b, 1, nq, j1 - j0), dtype=torch.bool)
    if key_mask is not None:
        vis = vis & key_mask[:, None, None, j0:j1]
    if causal:
        keys = torch.arange(j0, j1)
        vis = vis & (keys[None, :] <= torch.arange(nq)[:, None])
    return vis


def flash_fwd_tiles(q, k, v, scale, key_mask=None, causal=False,
                    tile=FWD_KEYS):
    """K4-fwd's recurrence on the TMA route, tile by tile. Returns (out in
    q's dtype, lse fp32)."""
    b, h, nq, _ = q.shape
    nk, dv = k.shape[2], v.shape[3]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m2 = torch.full((b, h, nq, 1), -math.inf)
    l = torch.zeros((b, h, nq, 1))
    o = torch.zeros((b, h, nq, dv))
    for j0 in range(0, nk, tile):
        j1 = min(nk, j0 + tile)
        s = qf @ kf[:, :, j0:j1].transpose(-1, -2)
        s = torch.where(visible(key_mask, causal, j0, j1, nq, b), s,
                        -math.inf)
        m_new = torch.maximum(m2, s.amax(-1, keepdim=True) * scale_log2)
        ms = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m2 - ms)
        p = torch.exp2(s * scale_log2 - ms)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).float() @ vf[:, :, j0:j1]
        m2 = m_new
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    lse = torch.where(l > 0, m2 * LN2 + torch.log(l), math.inf)[..., 0]
    return (o * inv).to(q.dtype), lse


def stats_tiles(q, k, v, dout, scale, key_mask=None, tile=BWD_KEYS):
    """The kStats sweep of K3-bwd's dq kernel, tile by tile: (lse, delta)
    per query row, fp32."""
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m2 = torch.full((b, h, nq, 1), -math.inf)
    l = torch.zeros((b, h, nq, 1))
    t = torch.zeros((b, h, nq, 1))
    for j0 in range(0, nk, tile):
        j1 = min(nk, j0 + tile)
        s = qf @ kf[:, :, j0:j1].transpose(-1, -2)
        dp = dof @ vf[:, :, j0:j1].transpose(-1, -2)
        s = torch.where(visible(key_mask, False, j0, j1, nq, b), s,
                        -math.inf)
        m_new = torch.maximum(m2, s.amax(-1, keepdim=True) * scale_log2)
        ms = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m2 - ms)
        p = torch.exp2(s * scale_log2 - ms)
        l = l * alpha + p.sum(-1, keepdim=True)
        t = t * alpha + (p * dp).sum(-1, keepdim=True)
        m2 = m_new
    seen = l > 0
    lse = torch.where(seen, m2 * LN2 + torch.log(l), math.inf)[..., 0]
    delta = torch.where(seen, t / torch.where(seen, l, 1.0), 0.0)[..., 0]
    return lse, delta


def bwd_from_stats(q, k, v, dout, lse, delta, scale, key_mask=None):
    """The products and roundings of the dq and dk/dv sweeps, given the
    stats: p = exp(s - lse), 0 where masked; dv = (p -> dout's dtype)^T .
    dout; ds = p (dout . v^T - delta) scale -> q's dtype; dq = ds . k;
    dk = ds^T . q."""
    s = q.float() @ k.float().transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None])
    if key_mask is not None:
        p = torch.where(key_mask[:, None, None, :], p, 0.0)
    do = dout.float()
    dv = p.to(dout.dtype).float().transpose(-1, -2) @ do
    ds = (p * (do @ v.float().transpose(-1, -2) - delta[..., None])
          * scale).to(q.dtype).float()
    return ((ds @ k.float()).to(q.dtype),
            (ds.transpose(-1, -2) @ q.float()).to(k.dtype), dv.to(v.dtype))


def check_k4_out(out, ref):
    """chip_smoke.check_flash_out's bf16 limits."""
    err = (out.float() - ref.float()).abs()
    top = ref.float().abs()
    assert err.max().item() <= K4_MAX_REL * top.max().item() + 1e-6
    assert err.mean().item() <= K4_MEAN_REL * top.mean().item()


def library_flash(q, k, v, mask, causal, scale):
    """The JAX package's flash call at its MLA site (v zero-padded to q's
    head dim, segment ids from the key mask), in interpret mode."""
    b, _, n, dqk = q.shape
    dv = v.shape[-1]
    v_in = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, dqk - dv)))
    segment_ids = None
    if mask is not None:
        segment_ids = SegmentIds(q=jnp.ones((b, n), jnp.int32),
                                 kv=jnp.asarray(mask).astype(jnp.int32))
    with pltpu.force_tpu_interpret_mode():
        out = flash_attention(q, k, v_in.astype(q.dtype),
                              segment_ids=segment_ids, causal=causal,
                              sm_scale=scale,
                              block_sizes=_flash_block_sizes(n))
    return np.array(out[..., :dv].astype(jnp.float32))


FWD_CASES = {  # name: ((B, H, N, Dqk, Dv), key mask, causal, dtype)
    "mla_bf16": ((2, 2, 700, 48, 32), False, False, torch.bfloat16),
    "masked_causal_bf16": ((2, 2, 300, 64, 64), True, True, torch.bfloat16),
    "wide_bf16": ((1, 2, 260, 128, 128), False, False, torch.bfloat16),
    "masked_fp32": ((2, 2, 300, 48, 32), True, False, torch.float32),
}


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_flash_fwd_tiles_match_plain(name):
    """K4-fwd's tile recurrence against flash_attention_plain: bf16 within
    the card's K4 limits (p rounded per tile against the plain version's
    rounded normalised p), fp32 within 1e-5 absolute (the same fp32 math in
    another order); lse within K4_LSE_TOL; a row whose keys are all masked
    gives out 0 and lse +inf on both sides."""
    (b, h, n, dqk, dv), mask, causal, dtype = FWD_CASES[name]
    q, k, v, _, key_mask = numpy_inputs(n + dqk, b, h, n, n, dqk, dv, mask)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    scale = dqk ** -0.5
    out, lse = flash_fwd_tiles(tq, tk, tv, scale, tm, causal)
    ref, ref_lse = tflash.flash_attention_plain(
        tq, tk, tv, scale=scale, key_mask=tm, causal=causal, return_lse=True)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.bfloat16:
        check_k4_out(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert torch.equal(lse.isinf(), ref_lse.isinf())
    finite = ref_lse.isfinite()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0,
                               atol=K4_LSE_TOL)
    if mask:
        assert not out[0].any() and bool(lse[0].isinf().all())


@pytest.mark.parametrize("dtype,mask,causal", [
    (torch.float32, False, False), (torch.float32, True, True),
    (torch.bfloat16, False, False)], ids=["fp32", "fp32_masked_causal",
                                          "bf16"])
def test_flash_fwd_tiles_match_jax_library(dtype, mask, causal):
    """K4-fwd's tile recurrence against the library flash kernel the JAX
    package calls (N = 256, Dqk 48, Dv 32; every row sees key 0): fp32
    within 2e-5 of the largest entry, bf16 within the K4 limits."""
    b, h, n, dqk, dv = 2, 2, 256, 48, 32
    q, k, v, _, key_mask = numpy_inputs(7, b, h, n, n, dqk, dv, mask)
    if mask:
        key_mask[:, 0] = True
    scale = dqk ** -0.5
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = library_flash(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                        key_mask, causal, scale)
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    out, _ = flash_fwd_tiles(*(torch.from_numpy(x).to(dtype)
                               for x in (q, k, v)), scale, tm, causal)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
    else:
        check_k4_out(out, torch.from_numpy(ref))


def plain_stats(q, k, v, dout, scale, key_mask):
    """The plain backward's lse (of the masked scores) and its delta =
    rowsum(dp o p) with p from the guarded softmax, and each row's
    sum of |dp p|."""
    s = q @ k.transpose(-1, -2) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], -math.inf)
    p = tvmem._probs(q, k, scale, key_mask)
    dp = dout @ v.transpose(-1, -2)
    return (torch.logsumexp(s, -1), (dp * p).sum(-1), (dp * p).abs().sum(-1))


@pytest.mark.parametrize("shape,mask", [
    ((2, 2, 300, 300, 48, 32), False),  # the MLA site's widths
    ((2, 2, 16, 276, 64, 64), False),  # the cross site's
    ((3, 2, 100, 260, 48, 80), True),  # ragged, an all-masked batch row
], ids=["mla", "cross", "ragged_masked"])
def test_stats_sweep_matches_plain(shape, mask):
    """The kStats sweep's lse and delta in fp32 against the plain softmax's:
    lse within 1e-6 relative, delta within 1e-6 of its row's sum of |terms|;
    the all-masked row gets lse +inf and delta 0."""
    b, h, nq, nk, dqk, dv = shape
    q, k, v, do, key_mask = (None if x is None else torch.from_numpy(x)
                             for x in numpy_inputs(nq + nk, b, h, nq, nk,
                                                   dqk, dv, mask))
    scale = dqk ** -0.5
    lse, delta = stats_tiles(q, k, v, do, scale, key_mask)
    ref_lse, ref_delta, terms = plain_stats(q, k, v, do, scale, key_mask)
    seen = ref_lse.isfinite()
    assert torch.equal(lse.isfinite(), seen)
    assert bool((lse[~seen] == math.inf).all())
    assert bool((delta[~seen] == 0).all())
    if mask:
        assert not bool(seen[0].any())
    assert ((lse[seen] - ref_lse[seen]).abs()
            <= 1e-6 * ref_lse[seen].abs()).all()
    assert ((delta - ref_delta).abs() <= 1e-6 * terms + 1e-30).all()


def _jax_grads(q, k, v, do, key_mask, scale, jdt):
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    jm = None if key_mask is None else jnp.asarray(key_mask)
    _, vjp = jax.vjp(lambda q, k, v: jvmem.vmem_attention(
        q, k, v, scale=scale, key_mask=jm, interpret=True), jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jdt))]


@pytest.mark.parametrize("dtype,mask", [(torch.float32, True),
                                        (torch.bfloat16, False)],
                         ids=["fp32_masked", "bf16"])
def test_stats_sweep_gradients_match_jax_kernel(dtype, mask):
    """The dq and dk/dv sweeps' products from the kStats sweep's lse and
    delta against jax.vjp through the JAX package's _bwd_kernel: fp32
    within 2e-5 of each gradient's largest entry, bf16 within one bf16 ulp
    of it (tests/test_torch_attention_vmem.py's limits for the plain
    backward); the all-masked batch row's dq and masked keys' dk, dv are
    exactly 0."""
    b, h, nq, nk, dqk, dv = 2, 2, 100, 260, 48, 32
    q, k, v, do, key_mask = numpy_inputs(3, b, h, nq, nk, dqk, dv, mask)
    scale = dqk ** -0.5
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax_grads(q, k, v, do, key_mask, scale, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    lse, delta = stats_tiles(tq, tk, tv, tdo, scale, tm)
    got = bwd_from_stats(tq, tk, tv, tdo, lse, delta, scale, tm)
    for g, r, label in zip(got, ref, ("dq", "dk", "dv")):
        top = np.abs(r).max()
        tol = (2e-5 * top if dtype == torch.float32
               else 2.0 ** (np.floor(np.log2(top)) - 7))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=tol,
                                   err_msg=label)
    if mask:
        assert not got[0][0].any()
        hidden = ~tm[:, None, :, None]
        assert not any(g.masked_select(hidden).any() for g in got[1:])


def vmem_fwd_tiles(q, k, v, scale, key_mask=None, masked_bias=-math.inf,
                   guarded=False, tile=VMEM_FWD_KEYS):
    """K3-fwd's two sweeps on the TMA route, tile by tile: a masked key's
    score plus ``masked_bias``; ``guarded``: the JAX kernel's guards (m2 at
    least -1e30 scale log2 e, 1 / max(l, 1e-30)), else the kernel's own
    (m2 = -inf read as 0, 1 / l = 0 where l = 0). Returns q's dtype."""
    b, h, nq, _ = q.shape
    nk, dv = k.shape[2], v.shape[3]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    bias = torch.zeros((b, nk))
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, masked_bias).float()

    def scores(j0, j1):
        return (qf @ kf[:, :, j0:j1].transpose(-1, -2)
                + bias[:, None, None, j0:j1])

    m2 = torch.full((b, h, nq, 1), -math.inf)
    l = torch.zeros((b, h, nq, 1))
    for j0 in range(0, nk, tile):  # the stats sweep
        s = scores(j0, min(nk, j0 + tile))
        m_new = torch.maximum(m2, s.amax(-1, keepdim=True) * c)
        if guarded:
            m_new = torch.clamp_min(m_new, -1e30 * c)
        ms = torch.where(m_new == -math.inf, 0.0, m_new)
        l = l * torch.exp2(m2 - ms) + torch.exp2(s * c - ms).sum(
            -1, keepdim=True)
        m2 = m_new
    ms = torch.where(m2 == -math.inf, 0.0, m2)
    inv_l = (1.0 / l.clamp_min(1e-30) if guarded
             else torch.where(l > 0, 1.0 / l, 0.0))
    o = torch.zeros((b, h, nq, dv))
    for j0 in range(0, nk, tile):  # the output sweep
        j1 = min(nk, j0 + tile)
        p = (torch.exp2(scores(j0, j1) * c - ms) * inv_l).to(v.dtype)
        o = o + p.float() @ vf[:, :, j0:j1]
    return o.to(q.dtype)


def _jax_vmem_fwd(q, k, v, key_mask, scale, jdt):
    return np.asarray(jvmem.vmem_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), scale=scale,
        key_mask=None if key_mask is None else jnp.asarray(key_mask),
        interpret=True).astype(jnp.float32))


VMEM_FWD_CASES = {  # name: (B, H, Nq, Nk, Dqk, Dv), key mask
    "mla": ((2, 2, 300, 300, 48, 32), False),  # the MLA site's widths
    "cross": ((2, 2, 16, 276, 64, 64), False),  # the cross site's
    "ragged_masked": ((3, 2, 100, 260, 48, 80), True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(VMEM_FWD_CASES))
def test_vmem_fwd_tiles_match_plain_and_jax_kernel(name, dtype):
    """K3-fwd's two sweeps against vmem_attention_plain and JAX's
    _fwd_kernel in interpret mode on the same inputs: fp32 within 1e-5 of
    the largest entry, bf16 within VMEM_TOL; the all-masked batch row
    exactly 0."""
    (b, h, nq, nk, dqk, dv), mask = VMEM_FWD_CASES[name]
    q, k, v, _, key_mask = numpy_inputs(nq + 3 * nk, b, h, nq, nk, dqk, dv,
                                        mask)
    scale = dqk ** -0.5
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    out = vmem_fwd_tiles(tq, tk, tv, scale, tm)
    assert out.dtype == dtype and out.shape == (b, h, nq, dv)
    plain = tvmem.vmem_attention_plain(tq, tk, tv, scale=scale, key_mask=tm)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax_vmem_fwd(q, k, v, key_mask, scale, jdt)
    for r in (plain.float().numpy(), ref):
        tol = (1e-5 * np.abs(r).max() if dtype == torch.float32
               else VMEM_TOL_BF16)
        np.testing.assert_allclose(out.float().numpy(), r, rtol=0, atol=tol)
    if mask:
        assert not out[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_vmem_fwd_masked_bias_neg_big_or_inf(dtype):
    """Under the guarded softmax a masked key's bias NEG_BIG (the JAX
    kernel's) and -inf (the card's) give the same output bit for bit, an
    all-masked row exactly 0 with either; the kernel's own guards over -inf
    biases give that same output."""
    b, h, nq, nk, dqk, dv = 3, 2, 70, 200, 48, 32
    q, k, v, _, key_mask = numpy_inputs(11, b, h, nq, nk, dqk, dv, mask=True)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tm = torch.from_numpy(key_mask)
    scale = dqk ** -0.5
    neg_big = vmem_fwd_tiles(tq, tk, tv, scale, tm, tvmem.NEG_BIG,
                             guarded=True)
    inf = vmem_fwd_tiles(tq, tk, tv, scale, tm, -math.inf, guarded=True)
    card = vmem_fwd_tiles(tq, tk, tv, scale, tm)
    assert torch.equal(neg_big, inf) and torch.equal(inf, card)
    assert not card[0].any() and bool(card[1:].abs().amax() > 0)
