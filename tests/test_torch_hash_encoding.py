"""The PyTorch port's hash encoding against the JAX package, on the CPU. The
K2 CUDA kernel is held against its plain version in
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
