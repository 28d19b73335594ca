"""The Grid4D encode (ops/grid4d_encode.py: every hash table of a Grid4D
encoder, times its masks, concatenated and cast once) against the JAX
package's Grid4DEncoder, on the CPU, forward and table gradient.

The card's kernel (``csrc/grid4d_encode.cu``) computes each table row as the
per-table kernel does and then masks and casts; ``kernel_order`` below
writes that order out in plain PyTorch (per table, level and corner, the
0/1 mask multiply in fp32, one cast), and the port's plain version must give
its bits. ``tests/test_torch_kernels_cuda.py`` holds the kernel against the
plain version bit for bit on the card.

Parameters come from the JAX encoder's ``init`` through
``load_flax_params``; inputs are numpy arrays from a seed, with exact grid
points of every level and the edges 0 and 1. JAX's ``combined`` (the input
of its ``proj_in``) is read with ``nn.intercept_methods``. Limits: in fp32
the encodings agree to rtol 1e-5 (atol 1e-10 for sums that cancel near 0;
tables are ~1e-4), as ``tests/test_torch_hash_encoding.py`` holds them, and
the encoder's output to 1e-4 absolute, as
``tests/test_torch_model.py::test_grid4d_matches_jax``; in bf16 ``combined``
within one bf16 ulp of JAX's (an fp32 value near a rounding boundary may
round either way). Table gradients: 1e-5 of the largest entry, as
``tests/test_torch_hash_encoding.py::test_table_gradient_matches_jax_vjp``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models.grid4d import Grid4DEncoder as JaxGrid4D
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import kernels, load_flax_params
from deepearth_tpu_torch.models.grid4d import Grid4DEncoder
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import grid4d_encode as g4
from deepearth_tpu_torch.ops.hash_encoding import HASH_PRIMES

torch.set_num_threads(2)

B, HIDDEN = 96, 64
_U32 = 0xFFFFFFFF
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# name: (decompositions, nearest, masks, dtype)
CASES = {
    "no_masks_fp32": (False, False, None, "fp32"),
    "partial_masks_fp32": (False, False, "partial", "fp32"),
    "all_false_masks_fp32": (False, False, "all_false", "fp32"),
    "no_masks_bf16": (False, False, None, "bf16"),
    "partial_masks_bf16": (False, False, "partial", "bf16"),
    "decompositions_partial_masks_fp32": (True, False, "partial", "fp32"),
    "decompositions_spatial_mask_bf16": (True, False, "spatial", "bf16"),
    "nearest_partial_masks_fp32": (False, True, "partial", "fp32"),
    "nearest_decompositions_bf16": (True, True, None, "bf16"),
}


def grid4d_kwargs(cfg_module, decompositions, nearest):
    """A small Grid4D config (4 + 2 levels on 2^10 tables; the
    decompositions 2 levels on 2^9) of either package."""
    kw = dict(n_spatial_levels=4, n_temporal_levels=2, hash_table_size=2 ** 10,
              use_decompositions=decompositions)
    if nearest:
        hc = cfg_module.HashEncodingConfig
        kw["spatial"] = hc(n_levels=4, hash_table_size=2 ** 10, coords_dim=3,
                           interpolation="nearest")
        kw["temporal"] = hc(n_levels=2, hash_table_size=2 ** 8, coords_dim=1,
                            base_resolution=4, interpolation="nearest")
        if decompositions:
            kw["decomposition"] = hc(n_levels=2, hash_table_size=2 ** 9,
                                     coords_dim=3, interpolation="nearest")
    return kw


def inputs(seed, masks):
    """xyzt with exact grid points of every level (multiples of 1/16) and
    rows at the edges 0 and 1; the masks as ``masks`` names them."""
    rng = np.random.default_rng(seed)
    xyzt = rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32)
    xyzt[: B // 4] = rng.integers(0, 17, (B // 4, 4)) / 16.0
    xyzt[0], xyzt[1], xyzt[2] = 0.0, 1.0, [0.0, 1.0, 1.0, 0.0]
    sm = rng.uniform(size=B) > 0.4
    tm = rng.uniform(size=B) > 0.4
    if masks == "all_false":
        sm, tm = np.zeros(B, bool), np.zeros(B, bool)
    return xyzt, {None: (None, None), "spatial": (sm, None)}.get(
        masks, (sm, tm))


def build(case):
    """The JAX encoder with its params, and the port's loaded with them."""
    decompositions, nearest, _, dtype = CASES[case]
    tdtype, jdtype = DTYPES[dtype]
    jax_cfg = jcfg.Grid4DConfig(**grid4d_kwargs(jcfg, decompositions, nearest))
    enc = JaxGrid4D(jax_cfg, HIDDEN, jdtype, jnp.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((B, 4)))["params"]
    cfg = tcfg.Grid4DConfig(**grid4d_kwargs(tcfg, decompositions, nearest))
    port = Grid4DEncoder(cfg, HIDDEN, Init(torch.Generator().manual_seed(0),
                                           device="cpu"), tdtype)
    load_flax_params(port, jax.tree_util.tree_map(np.asarray, params))
    return enc, params, port


def jax_combined(enc, params, xyzt, sm, tm):
    """JAX's encoder output and its ``combined`` (proj_in's input)."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        if context.module.name == "proj_in":
            seen["combined"] = args[0]
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(grab):
        out = enc.apply({"params": params}, jnp.asarray(xyzt),
                        None if sm is None else jnp.asarray(sm),
                        None if tm is None else jnp.asarray(tm))
    return out, seen["combined"]


def encoders(port):
    encs = [port.spatial, port.temporal]
    if port.cfg.use_decompositions:
        encs += [getattr(port, name) for name in g4.DECOMPOSITIONS]
    return encs


def kernel_order(xyzt, encs, sm, tm, out_dtype):
    """The card kernel's arithmetic written out: for each table, level and
    corner (bit d of corner c the offset on axis d) the uint32 XOR-prime
    row and the d-linear weight as a product over d, the fp32 sum from 0
    in corner order (nearest: the row itself), the 0/1 mask multiply in
    fp32, then one cast of the whole row."""
    cols = []
    for (_, axes, bits), enc in zip(g4.TABLES, encs):
        tables, res = enc.tables.detach(), enc.resolutions
        size = enc.cfg.hash_table_size
        x = torch.stack([xyzt[:, a] for a in axes], -1)
        mask = None
        for bit, m in ((1, sm), (2, tm)):
            if bits & bit and m is not None:
                mask = m if mask is None else mask & m
        corners = (range(1 << x.shape[1])
                   if enc.cfg.interpolation == "linear" else [0])
        for level, r in enumerate(res):
            s = x * r
            floor = torch.floor(s)
            grid, frac = floor.to(torch.int32).to(torch.int64), s - floor
            acc = torch.zeros((x.shape[0], 2))
            for c in corners:
                h = torch.zeros(x.shape[0], dtype=torch.int64)
                w = torch.ones(x.shape[0])
                for d in range(x.shape[1]):
                    bit = (c >> d) & 1
                    h = h ^ ((((grid[:, d] + bit) & _U32) * HASH_PRIMES[d])
                             & _U32)
                    w = w * (frac[:, d] if bit else 1.0 - frac[:, d])
                h = h & (size - 1) if size & (size - 1) == 0 else h % size
                row = tables[level][h]
                acc = row if len(corners) == 1 else acc + w[:, None] * row
            if mask is not None:
                acc = acc * mask[:, None].to(torch.float32)
            cols.append(acc)
    return torch.cat(cols, -1).to(out_dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (a normal's exponent less 7 bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def as_numpy(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


@pytest.mark.parametrize("case", CASES)
def test_grid4d_encode_matches_jax(case):
    """combined (the port's, read at proj_in, and the written-out kernel
    order) against JAX's; the encoder's output against JAX's in fp32."""
    enc, params, port = build(case)
    xyzt, (sm, tm) = inputs(len(case), CASES[case][2])
    ref_out, ref = jax_combined(enc, params, xyzt, sm, tm)
    seen = {}
    port.proj_in.register_forward_pre_hook(
        lambda mod, args: seen.update(combined=args[0]))
    tx = torch.from_numpy(xyzt)
    tsm, ttm = (None if m is None else torch.from_numpy(m) for m in (sm, tm))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = port(tx, tsm, ttm)
    assert set(kernels.launch_counts.values()) == {0}  # CPU: plain versions
    combined = seen["combined"]
    assert combined.dtype == port.compute_dtype
    assert combined.shape == (B, port.cfg.output_dim)
    # the written-out kernel order is the plain version's, bit for bit
    assert torch.equal(kernel_order(tx, encoders(port), tsm, ttm,
                                    port.compute_dtype), combined)
    got, want = as_numpy(combined), as_numpy(ref)
    if port.compute_dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)
        np.testing.assert_allclose(as_numpy(out), as_numpy(ref_out), rtol=0,
                                   atol=1e-4)
    else:
        assert (np.abs(got - want) <= bf16_ulp(want)).all()
    # masked rows are exactly 0 in every table the mask applies to
    if sm is not None:
        assert not combined[~tsm, :2 * port.cfg.spatial.n_levels].any()


@pytest.mark.parametrize("case", CASES)
def test_table_gradient_matches_jax_vjp(case):
    """The tables' gradient through the Grid4D encode's autograd.Function
    against jax.vjp of JAX's combined; the cotangent in the compute dtype."""
    enc, params, port = build(case)
    xyzt, (sm, tm) = inputs(len(case) + 100, CASES[case][2])
    names = [name for name, _, _ in g4.TABLES[:len(encoders(port))]]
    cot = np.random.default_rng(len(case)).standard_normal(
        (B, port.cfg.output_dim)).astype(np.float32)
    jdtype = DTYPES[CASES[case][3]][1]

    def combined_of(tables):
        p = {**params, **{n: {"tables": t} for n, t in tables.items()}}
        return jax_combined(enc, p, xyzt, sm, tm)[1]

    _, vjp = jax.vjp(combined_of, {n: params[n]["tables"] for n in names})
    ref = vjp(jnp.asarray(cot).astype(jdtype))[0]
    encs = encoders(port)
    combined = g4.grid4d_encode(
        torch.from_numpy(xyzt), [e.tables for e in encs],
        [e.resolutions for e in encs], [e.cfg for e in encs],
        *(None if m is None else torch.from_numpy(m) for m in (sm, tm)),
        out_dtype=port.compute_dtype)
    combined.backward(torch.from_numpy(cot).to(port.compute_dtype))
    for name, e in zip(names, encs):
        want = np.asarray(ref[name])
        assert e.tables.grad.dtype == torch.float32
        np.testing.assert_allclose(e.tables.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_route_rule():
    """One launch for every Grid4D configuration (F = 2, D <= 4, fp32 or
    bf16 out); else the per-table route."""
    route = kernels.grid4d_encode_route
    assert route([(2, 3), (2, 1)], torch.bfloat16)
    assert route([(2, 3), (2, 1)] + [(2, 3)] * 3, torch.float32)
    assert not route([(3, 3), (3, 1)], torch.bfloat16)  # F = 3
    assert not route([(2, 5), (2, 1)], torch.bfloat16)  # D = 5
    assert not route([(2, 3), (2, 1)], torch.float16)


def test_per_table_route_matches_the_plain_version():
    """F = 3 takes each table through hash_encode (the per-table kernel on the
    card); on the CPU that is the plain composition, and no kernel runs."""
    cfg = tcfg.Grid4DConfig(n_spatial_levels=3, n_temporal_levels=2,
                            n_features_per_level=3, hash_table_size=2 ** 9)
    port = Grid4DEncoder(cfg, HIDDEN, Init(torch.Generator().manual_seed(1),
                                           device="cpu"), torch.bfloat16)
    xyzt, (sm, tm) = inputs(7, "partial")
    encs = encoders(port)
    args = (torch.from_numpy(xyzt), [e.tables for e in encs],
            [e.resolutions for e in encs], [e.cfg for e in encs],
            torch.from_numpy(sm), torch.from_numpy(tm))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = g4.grid4d_encode(*args, out_dtype=torch.bfloat16)
        want = g4.grid4d_encode_plain(*args, out_dtype=torch.bfloat16)
    assert set(kernels.launch_counts.values()) == {0}
    assert got.shape == (B, 15) and torch.equal(got, want)


def test_xyzt_gradient_raises():
    cfg = tcfg.Grid4DConfig(n_spatial_levels=2, n_temporal_levels=2,
                            hash_table_size=2 ** 8)
    port = Grid4DEncoder(cfg, HIDDEN, Init(torch.Generator().manual_seed(2),
                                           device="cpu"), torch.float32)
    with pytest.raises(NotImplementedError, match="xyzt"):
        port(torch.rand((4, 4), requires_grad=True))
