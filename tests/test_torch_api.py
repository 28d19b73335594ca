"""The port's embedding service API (``deepearth_tpu_torch.api``) against the
JAX package's (``deepearth_tpu.api``), on the CPU.

Parity goes through ``save`` / ``load``: both packages write
``registry.json`` and ``params.pkl`` (the flax tree as numpy arrays), and a
model saved by one loads into the other. The two inits are not alike (a
``torch.Generator`` against ``PRNGKey``), so parameters always travel this
way. Models are at JAX's own test width (hidden 64, one fusion layer), two
sources (a 3-wide numerical one and a categorical one), Grid4D 8 + 4 levels
on 2^15 tables; a single point through ``predict`` and through
``predict_batch`` (for its reconstructions), and a batch of 4 with
altitudes and times of every kind. This file holds JAX's saves loaded by
the port; ``test_torch_api_port.py`` the port's loaded by JAX.

Tolerances, of each output's largest entry:
- fp32 compute (``compute_dtype`` set on both sides): ``FP32_REL`` = 1e-5.
  The same fp32 operations summed in other orders read at most 3.4e-7 of
  the largest entry (3 seeds, every output).
- bf16 compute (the API's default): ``BF16_REL`` = 2^-4. Kernel-free plain
  versions on both sides round to bf16 at different points (XLA fuses
  casts away that the eager port keeps), and one layer carries each
  difference on: read at most 2.4% of the largest entry (the species
  logits; the embedding 0.94%) over 3 seeds, held at about 2.6 times that.
"""

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import api as japi
from deepearth_tpu_torch import api as tapi

torch.set_num_threads(2)

H, L = 64, 1
FP32_REL, BF16_REL = 1e-5, 2 ** -4
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_REL),
          "float32": (torch.float32, jnp.float32, FP32_REL)}
POINT = {"location": (28.5, -81.4), "time": "2024-06-15",
         "data": {"temperature": [22.3, 0.5, -1.0], "species": 3}}
LOCATIONS = [(28.5, -81.4, 12.0), (27.9, -82.5, 0.0), (-33.9, 151.2, 120.0),
             (64.1, -21.9, 30.0)]
TIMES = ["2024-06-15", "2031-07-01T12:00:00", None, 0.25]


def batch_data(seed):
    rng = np.random.default_rng(seed)
    return {"temperature": rng.standard_normal((4, 3)),
            "species": rng.integers(0, 10, 4)}


def register(earth):
    earth.register("temperature", shape=(3,), type="numerical")
    earth.register("species", type="categorical", num_classes=10)
    return earth


def jax_earth(dtype="bfloat16"):
    earth = japi.DeepEarth(hidden_dim=H, n_layers=L)
    earth._config.compute_dtype = DTYPES[dtype][1]
    return earth


def port_earth(dtype="bfloat16", seed=0):
    earth = tapi.DeepEarth(hidden_dim=H, n_layers=L, seed=seed, device="cpu")
    earth._config.compute_dtype = DTYPES[dtype][0]
    return earth


def outputs(earth):
    """The point's embedding (predict), the point's and the batch's
    embeddings and reconstructions (predict_batch)."""
    emb = earth.predict(**POINT)
    point = earth.predict_batch(
        [POINT["location"]], [POINT["time"]],
        {k: np.asarray(v).reshape(1, -1) for k, v in POINT["data"].items()},
        return_reconstructions=True)
    batch = earth.predict_batch(LOCATIONS, TIMES, batch_data(1),
                                return_reconstructions=True)
    return {"predict": emb, "point": point[0], "batch": batch[0],
            **{f"point/{k}": v for k, v in point[1].items()},
            **{f"batch/{k}": v for k, v in batch[1].items()}}


def assert_close(port, ref, rel):
    assert set(port) == set(ref)
    for key, value in ref.items():
        value = np.asarray(value, np.float32)
        assert port[key].dtype == np.float32, key
        assert port[key].shape == value.shape, key
        err = float(np.abs(port[key] - value).max())
        assert err <= rel * float(np.abs(value).max()), (key, err)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """A JAX model built by its first predict over both sources and saved,
    with its outputs in bf16 and, loaded again with fp32 compute, in fp32."""
    path = str(tmp_path_factory.mktemp("jax_saved"))
    earth = register(jax_earth())
    ref = {"bfloat16": outputs(earth)}
    earth.save(path)
    ref["float32"] = outputs(jax_earth("float32").load(path))
    return path, ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_saved_model_predicts_alike_in_the_port(jax_saved, dtype):
    path, ref = jax_saved
    earth = port_earth(dtype).load(path)
    assert earth.sources == {
        "temperature": {"shape": (3,), "type": "numerical",
                        "num_classes": None},
        "species": {"shape": (), "type": "categorical", "num_classes": 10}}
    assert_close(outputs(earth), ref[dtype], DTYPES[dtype][2])


def test_saved_trees_have_the_same_leaves(jax_saved, tmp_path):
    """The port's save writes the leaves, shapes and dtypes JAX's does."""
    import pickle

    earth = register(port_earth())
    earth.predict(**POINT)
    earth.save(str(tmp_path))

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v).shape, np.asarray(v).dtype

    trees = []
    for path in (jax_saved[0], str(tmp_path)):
        with open(f"{path}/params.pkl", "rb") as f:
            trees.append(sorted(leaves(pickle.load(f))))
    assert trees[0] == trees[1]


ONLY_TEMPERATURE = {"location": (10.0, 20.0), "time": "2010-01-01",
                    "data": {"temperature": [1.0, 2.0, 3.0]}}


def test_jax_model_built_without_a_source_loads_into_the_port(tmp_path):
    """JAX's first predict leaves ``species`` out: its tree has no
    ``embed_species``, ``decoder_species`` or ``modality_embed_species``.
    The port loads that tree, predicts the same, and refuses ``species``
    as JAX does."""
    earth = register(jax_earth())
    ref = earth.predict(**ONLY_TEMPERATURE)
    earth.save(str(tmp_path))
    with pytest.raises(flax.errors.ScopeParamNotFoundError):
        earth.predict(**POINT)
    port = port_earth().load(str(tmp_path))
    assert port._model.modality_names == ["temperature"]
    assert_close({"e": port.predict(**ONLY_TEMPERATURE)}, {"e": ref},
                 BF16_REL)
    with pytest.raises(ValueError, match="species"):
        port.predict(**POINT)
