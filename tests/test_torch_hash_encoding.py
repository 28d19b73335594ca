"""The PyTorch port's hash encoding against the JAX package, on the CPU,
forward and table gradient (jax.vjp against the port's autograd.Function).
The K2 CUDA kernels are held against their plain versions in
tests/test_torch_kernels_cuda.py.

Indices must be exactly equal. Encodings use the same fp32 operations in the
same corner and weight order, so they agree to rtol 1e-5 (atol 1e-10 for
sums that cancel near zero; tables are ~1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu.configs import HashEncodingConfig as JaxHashCfg
from deepearth_tpu.ops import hash_encoding as jhe
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import HashEncodingConfig
from deepearth_tpu_torch.ops import hash_encoding as the

torch.set_num_threads(2)


def coords_np(seed, n, d):
    """Uniform coordinates plus exact grid points of every level and 1.0."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    c[: n // 4] = rng.integers(0, 17, (n // 4, d)) / 16.0
    c[0], c[1] = 0.0, 1.0
    return c


def tables_np(seed, levels, table, f=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1e-4, 1e-4, (levels, table, f)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("table_size", [2 ** 10, 3001])
def test_hash_grid_indices_exact(d, table_size):
    # full int32 range: negative and large cells make the uint32 wrap matter
    rng = np.random.default_rng(d)
    g = rng.integers(-2 ** 31, 2 ** 31, (4096, d)).astype(np.int32)
    g[0] = 2 ** 31 - 1
    ref = np.asarray(jhe.hash_grid_indices(jnp.asarray(g), table_size, d))
    out = the.hash_grid_indices(torch.from_numpy(g), table_size, d)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
@pytest.mark.parametrize("d,levels,table", [(1, 4, 256), (2, 3, 512),
                                            (3, 4, 1024), (3, 4, 3001),
                                            (4, 2, 1024)])
def test_hash_encode_matches_jax(interpolation, d, levels, table):
    coords = coords_np(d, 512, d)
    tables = tables_np(levels, levels, table)
    res = np.array([2.0 ** (4 + i) for i in range(levels)], np.float32)
    ref = jhe.hash_encode(jnp.asarray(coords), jnp.asarray(tables),
                          jnp.asarray(res), interpolation=interpolation,
                          table_size=table)
    out = the.hash_encode(torch.from_numpy(coords), torch.from_numpy(tables),
                          torch.from_numpy(res), interpolation=interpolation,
                          table_size=table)
    assert out.shape == (512, levels * 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-10)


def test_hash_encode_general_features_and_batch_shape():
    """F != 2 and a leading batch shape, as jnp.take handles them."""
    coords = coords_np(7, 60, 3).reshape(4, 15, 3)
    tables = tables_np(8, 3, 1024, f=3)
    res = np.array([16.0, 32.0, 64.0], np.float32)
    ref = jhe.hash_encode(jnp.asarray(coords), jnp.asarray(tables),
                          jnp.asarray(res))
    out = the.hash_encode(torch.from_numpy(coords), torch.from_numpy(tables),
                          torch.from_numpy(res))
    assert out.shape == (4, 15, 9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-10)


def test_hash_encoding_module_matches_jax():
    jcfg = JaxHashCfg(n_levels=4, hash_table_size=1024, coords_dim=3)
    cfg = HashEncodingConfig(n_levels=4, hash_table_size=1024, coords_dim=3)
    assert cfg.resolutions == jcfg.resolutions
    coords = coords_np(9, 256, 3)
    mod = jhe.HashEncoding(jcfg)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(coords))
    ref = mod.apply(params, jnp.asarray(coords))
    port = the.HashEncoding(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.tables.copy_(torch.tensor(np.asarray(
            params["params"]["tables"])))
        out = port(torch.from_numpy(coords))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-10)


def test_init_tables_shape_range_and_dtype():
    cfg = HashEncodingConfig(n_levels=3, hash_table_size=512,
                             n_features_per_level=2)
    mod = the.HashEncoding(cfg, torch.bfloat16,
                           generator=torch.Generator().manual_seed(1))
    t = mod.tables.detach()
    assert t.shape == (3, 512, 2) and t.dtype == torch.float32  # fp32 under bf16
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 1e-5
    again = the.init_hash_tables(cfg, generator=torch.Generator().manual_seed(1))
    assert torch.equal(t, again)


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launch_counts()
    coords = torch.from_numpy(coords_np(1, 64, 3))
    tables = torch.from_numpy(tables_np(1, 2, 256))
    res = torch.tensor([16.0, 32.0])
    out = the.hash_encode(coords, tables, res)
    assert torch.equal(out, the.hash_encode_plain(coords, tables, res))
    assert kernels.launch_counts["hash_encode_fwd"] == 0


def test_other_devices_raise_instead_of_falling_back():
    coords = torch.empty((8, 3), device="meta")
    tables = torch.empty((2, 256, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        the.hash_encode(coords, tables, torch.empty(2, device="meta"))


# --------------------------------------------------------------------------- #
# the table gradient (K2-bwd's plain version and the autograd.Function)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
@pytest.mark.parametrize("d,levels,table,f", [
    (1, 4, 256, 2),  # the temporal stack's D, through _packed_gather_bwd
    (3, 4, 1024, 2),  # the spatial stack's D
    (3, 3, 3001, 2),  # T not a power of two
    (4, 2, 1024, 2),
    (3, 3, 512, 3),  # F != 2: JAX transposes a jnp.take instead
])
def test_table_gradient_matches_jax_vjp(interpolation, d, levels, table, f):
    """Scatter sums in another order: rtol 1e-5 of the largest entry."""
    coords = coords_np(d + 10, 512, d)
    tables = tables_np(levels, levels, table, f)
    res = np.array([2.0 ** (4 + i) for i in range(levels)], np.float32)
    grad_out = np.random.default_rng(d).standard_normal(
        (512, levels * f)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jhe.hash_encode(
        jnp.asarray(coords), t, jnp.asarray(res),
        interpolation=interpolation, table_size=table), jnp.asarray(tables))
    ref = np.asarray(vjp(jnp.asarray(grad_out))[0])
    t = torch.from_numpy(tables).requires_grad_()
    the.hash_encode(torch.from_numpy(coords), t, torch.from_numpy(res),
                    interpolation=interpolation, table_size=table).backward(
        torch.from_numpy(grad_out))
    assert t.grad.shape == tables.shape and t.grad.dtype == torch.float32
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    plain = the.hash_encode_bwd_plain(
        torch.from_numpy(coords), torch.from_numpy(grad_out),
        torch.from_numpy(res), tables.shape, interpolation=interpolation,
        table_size=table)
    assert torch.equal(plain, t.grad)


def test_table_gradient_with_batch_shape_and_partial_table():
    """A leading batch shape and a hash modulus below the table's length:
    rows past the modulus get no gradient."""
    coords = coords_np(30, 60, 3).reshape(4, 15, 3)
    tables = tables_np(31, 2, 1024)
    res = np.array([16.0, 32.0], np.float32)
    grad_out = np.ones((4, 15, 4), np.float32)
    _, vjp = jax.vjp(lambda t: jhe.hash_encode(
        jnp.asarray(coords), t, jnp.asarray(res), table_size=1000),
        jnp.asarray(tables))
    ref = np.asarray(vjp(jnp.asarray(grad_out))[0])
    t = torch.from_numpy(tables).requires_grad_()
    the.hash_encode(torch.from_numpy(coords), t, torch.from_numpy(res),
                    table_size=1000).backward(torch.from_numpy(grad_out))
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-6)
    assert (t.grad[:, 1000:] == 0).all()


def test_coords_gradient_raises():
    coords = torch.rand((8, 3), requires_grad=True)
    tables = torch.zeros((2, 256, 2), requires_grad=True)
    with pytest.raises(NotImplementedError, match="coords"):
        the.hash_encode(coords, tables, torch.tensor([16.0, 32.0]))
    with torch.no_grad():  # no graph, no gradient asked for
        the.hash_encode(coords, tables, torch.tensor([16.0, 32.0]))


def test_module_gradient_reaches_the_tables():
    cfg = HashEncodingConfig(n_levels=3, hash_table_size=256, coords_dim=1)
    mod = the.HashEncoding(cfg, generator=torch.Generator().manual_seed(2))
    mod(torch.from_numpy(coords_np(3, 32, 1))).square().sum().backward()
    assert mod.tables.grad is not None and mod.tables.grad.abs().sum() > 0
