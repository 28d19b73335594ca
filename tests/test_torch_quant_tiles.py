"""The reduction order of K7's and K6's tensor-core routes, on the CPU.

No CUDA kernel runs here, so ``kernels/csrc/quant_matmul_tc.cu``'s
reduction is written out in plain PyTorch as the kernel runs it and held
against the JAX package's ``int4_bmm`` / ``int8_bmm`` (their Pallas kernels
in interpret mode) and ``int4_bmm_plain`` / ``int8_bmm_plain`` on the same
numpy inputs. K7:

- the nibbles widened as the kernel widens them (each byte XOR 0x88, a
  nibble u is u - 8), which is the sign extension of the split-half layout;
- the packed rows of each 128-feature tile split over the cluster of
  ``kernels.int4_tc_plan`` (its chunk per rank), each chunk in stages of 64
  rows whose 8 k16 steps go two to each of 4 warps;
- a k16 step is 8 packed rows: their low nibbles against x[:, rows] and
  their high nibbles against x[:, D/2 + rows] in one 16-deep fp32 product;
- each warp's products added in turn, the block's 4 warps in warp order,
  the cluster's blocks in rank order, then the scale, then one cast.

K6 the same over int8 weights: each byte widened as the kernel widens it
(128 + its low 7 bits over a bias of 128 or 256, subtracted in bf16), the
D rows split over the cluster of ``kernels.int8_tc_plan``, each chunk in
stages of 64 rows whose 4 k16 steps of 16 rows go one to each warp.

fp32 outputs within 1e-5 of the largest entry, bf16 within one bf16 ulp of
it (``tests/test_torch_quant.py``'s limits for the plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu.ops import quant as jq
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

REL = 1e-5
STAGE_ROWS, WARPS = kernels.QUANT_TC_ROWS, 4


def widen(w_p: torch.Tensor):
    """The kernel's widening of the packed bytes: (lo, hi) nibble values."""
    u = (w_p.to(torch.int32) & 0xFF) ^ 0x88
    return ((u & 0xF) - 8).float(), (((u >> 4) & 0xF) - 8).float()


def k7_tiles(x, w_p, scale, out_dtype):
    """K7's tensor-core reduction, step by step. x (E, C, D), w_p
    (E, D/2, Fp) split-half bytes, scale (E, 1, F)."""
    e, c, d = x.shape
    rows, fp, f = d // 2, w_p.shape[2], scale.shape[2]
    _, _, cluster, chunk = kernels.int4_tc_plan(e, c, rows, fp)
    xb = x.to(torch.bfloat16).float()
    lo, hi = widen(w_p)
    total = torch.zeros((e, c, fp))
    for rank in range(cluster):
        warps = [torch.zeros((e, c, fp)) for _ in range(WARPS)]
        for stage in range(chunk // STAGE_ROWS):
            for w in range(WARPS):
                for step in (2 * w, 2 * w + 1):
                    r0 = rank * chunk + stage * STAGE_ROWS + 8 * step
                    a = torch.cat([lo[:, r0:r0 + 8], hi[:, r0:r0 + 8]], 1)
                    b = torch.cat([xb[:, :, r0:r0 + 8],
                                   xb[:, :, rows + r0:rows + r0 + 8]], 2)
                    warps[w] = warps[w] + b @ a
        block = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        total = total + block
    return (total[..., :f] * scale).to(out_dtype)


def case(seed, e, c, d, f, x_dtype):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((e, d, f))
         * r.uniform(0.05, 3.0, size=f)).astype(np.float32)
    x = r.standard_normal((e, c, d)).astype(np.float32)
    w_p, s = tq.quantize_int4(torch.from_numpy(w))
    return torch.from_numpy(x).to(x_dtype), w_p, s


def close(out, ref, dtype):
    ref = np.asarray(ref, np.float32)
    top = np.abs(ref).max()
    tol = (REL * top if dtype == torch.float32
           else 2.0 ** (np.floor(np.log2(top)) - 7))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)


TC_CASES = {  # (E, C, D, F): the plan's cluster and chunk in the id
    "E2 C5 D512 F200 (cluster 4, chunk 64)": (2, 5, 512, 200),
    "E8 C4 D1024 F1000 (cluster 4, chunk 128)": (8, 4, 1024, 1000),
    "E1 C17 D2048 F256 (cluster 16, chunk 64)": (1, 17, 2048, 256),
    "E3 C40 D256 F130 (two column tiles)": (3, 40, 256, 130),
}


def test_cases_cover_the_plans_they_name():
    plans = [kernels.int4_tc_plan(e, c, d // 2, -(-f // 128) * 128)
             for e, c, d, f in TC_CASES.values()]
    assert [(p[2], p[3]) for p in plans[:3]] == [(4, 64), (4, 128), (16, 64)]
    assert plans[3][1] == 2 and all(
        kernels.int4_bmm_tc_route(e, c, d, -(-f // 128) * 128)
        for e, c, d, f in TC_CASES.values())


def test_widening_is_the_sign_extension():
    w_p = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    lo, hi = widen(w_p[None])
    ref_lo, ref_hi = tq._unpack_int4(w_p[None])
    assert torch.equal(lo, ref_lo.float()) and torch.equal(hi, ref_hi.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(TC_CASES))
def test_k7_reduction_matches_jax_kernel_and_plain(name, dtype):
    e, c, d, f = TC_CASES[name]
    x, w_p, s = case(d + c, e, c, d, f, dtype)
    out = k7_tiles(x, w_p, s, dtype)
    assert out.shape == (e, c, f) and out.dtype == dtype
    close(out, tq.int4_bmm_plain(x, w_p, s, dtype).float().numpy(), dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jq.int4_bmm(jnp.asarray(x.float().numpy()).astype(jdt),
                      jnp.asarray(w_p.numpy()), jnp.asarray(s.numpy()),
                      out_dtype=jdt, interpret=True)
    close(out, np.asarray(ref.astype(jnp.float32)), dtype)


def widen_int8(w_q: torch.Tensor) -> torch.Tensor:
    """The kernel's widening of int8 bytes b (widen_int8_pair): the bf16
    128 + (b & 127) minus the bf16 128, or 256 where b's sign bit is set,
    subtracted in bf16."""
    u = w_q.to(torch.int32) & 0xFF
    biased = ((u & 0x7F) | 0x4300).to(torch.int16).view(torch.bfloat16)
    bias = ((u & 0x80) | 0x4300).to(torch.int16).view(torch.bfloat16)
    return (biased - bias).float()


def k6_tiles(x, w_q, scale, out_dtype):
    """K6's tensor-core reduction, step by step. x (E, C, D), w_q
    (E, D, Fp) int8, scale (E, 1, F)."""
    e, c, d = x.shape
    fp, f = w_q.shape[2], scale.shape[2]
    _, _, cluster, chunk = kernels.int8_tc_plan(e, c, d, fp)
    xb = x.to(torch.bfloat16).float()
    w = widen_int8(w_q)
    total = torch.zeros((e, c, fp))
    for rank in range(cluster):
        warps = [torch.zeros((e, c, fp)) for _ in range(WARPS)]
        for stage in range(chunk // STAGE_ROWS):
            for warp in range(WARPS):
                r0 = rank * chunk + stage * STAGE_ROWS + 16 * warp
                warps[warp] = (warps[warp]
                               + xb[:, :, r0:r0 + 16] @ w[:, r0:r0 + 16])
        block = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        total = total + block
    return (total[..., :f] * scale).to(out_dtype)


K6_CASES = {  # (E, C, D, F): the plan's cluster and chunk in the id
    "E1 C1 D512 F200 (cluster 8, chunk 64)": (1, 1, 512, 200),
    "E1 C5 D1024 F256 (cluster 16, chunk 64)": (1, 5, 1024, 256),
    "E1 C8 D768 F384 (cluster 4, chunk 192)": (1, 8, 768, 384),
    "E1 C32 D256 F130 (cluster 4, chunk 64)": (1, 32, 256, 130),
    "E4 C4 D512 F256 (cluster 8, chunk 64)": (4, 4, 512, 256),
}


def int8_case(seed, e, c, d, f, x_dtype):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((e, d, f))
         * r.uniform(0.05, 3.0, size=f)).astype(np.float32)
    x = r.standard_normal((e, c, d)).astype(np.float32)
    w_q, s = tq.quantize_int8(torch.from_numpy(w))
    return torch.from_numpy(x).to(x_dtype), w_q, s


def test_k6_cases_cover_the_plans_they_name():
    plans = [kernels.int8_tc_plan(e, c, d, -(-f // 128) * 128)
             for e, c, d, f in K6_CASES.values()]
    assert [(p[2], p[3]) for p in plans] == [(8, 64), (16, 64), (4, 192),
                                              (4, 64), (8, 64)]
    assert all(kernels.int8_bmm_tc_route(e, c, d, -(-f // 128) * 128)
               for e, c, d, f in K6_CASES.values())


def test_int8_widening_is_exact():
    w_q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(widen_int8(w_q), w_q.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(K6_CASES))
def test_k6_reduction_matches_jax_kernel_and_plain(name, dtype):
    e, c, d, f = K6_CASES[name]
    x, w_q, s = int8_case(d + c + 1, e, c, d, f, dtype)
    out = k6_tiles(x, w_q, s, dtype)
    assert out.shape == (e, c, f) and out.dtype == dtype
    close(out, tq.int8_bmm_plain(x, w_q, s, dtype).float().numpy(), dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jq.int8_bmm(jnp.asarray(x.float().numpy()).astype(jdt),
                      jnp.asarray(w_q.numpy()), jnp.asarray(s.numpy()),
                      out_dtype=jdt, interpret=True)
    close(out, np.asarray(ref.astype(jnp.float32)), dtype)
