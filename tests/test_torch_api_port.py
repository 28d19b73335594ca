"""The port's embedding service API (``deepearth_tpu_torch.api``) on the
CPU: a model the port saves loads into the JAX package's ``DeepEarth`` and
predicts alike (fixtures, widths and tolerances of ``test_torch_api.py``,
which holds the other direction), and the port's copies of the JAX
package's own API and file-loader tests (``tests/test_evaluation_api.py``).
"""

import numpy as np
import pytest
import torch

from deepearth_tpu import api as japi
from deepearth_tpu_torch import api as tapi
from test_torch_api import (
    BF16_REL,
    DTYPES,
    LOCATIONS,
    ONLY_TEMPERATURE,
    POINT,
    TIMES,
    assert_close,
    batch_data,
    jax_earth,
    outputs,
    port_earth,
    register,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_saved(tmp_path_factory):
    """The same from the port: built by its first predict and saved."""
    path = str(tmp_path_factory.mktemp("port_saved"))
    earth = register(port_earth(seed=3))
    ref = {"bfloat16": outputs(earth)}
    earth.save(path)
    ref["float32"] = outputs(port_earth("float32").load(path))
    return path, ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_saved_model_predicts_alike_in_jax(port_saved, dtype):
    path, ref = port_saved
    got = outputs(jax_earth(dtype).load(path))
    got = {k: np.asarray(v, np.float32) for k, v in got.items()}
    # held the other way round: the port's outputs against JAX's
    assert_close(ref[dtype], got, DTYPES[dtype][2])


def test_port_model_built_without_a_source_loads_into_jax(tmp_path):
    import pickle

    earth = register(port_earth())
    ref = earth.predict(**ONLY_TEMPERATURE)
    with pytest.raises(ValueError, match="species"):
        earth.predict(**POINT)
    earth.save(str(tmp_path))
    with open(tmp_path / "params.pkl", "rb") as f:
        tree = pickle.load(f)
    assert not [k for k in tree if "species" in k]
    assert "modality_embed_species" not in tree["fusion"]["st_embedding"]
    got = jax_earth().load(str(tmp_path)).predict(**ONLY_TEMPERATURE)
    assert_close({"e": ref}, {"e": got}, BF16_REL)


# -- the port's copies of the JAX package's own API tests ------------------- #


class TestDeepEarthAPI:
    def test_register_predict_roundtrip(self, tmp_path):
        earth = tapi.DeepEarth(hidden_dim=64, n_layers=1, device="cpu")
        earth.register("temperature", shape=(1,), type="numerical")
        earth.register("species", type="categorical", num_classes=10)
        emb = earth.predict(
            location=(28.5, -81.4),
            time="2024-06-15",
            data={"temperature": [22.3], "species": 3},
        )
        assert emb.shape == (64,)
        assert np.isfinite(emb).all()

        # batch prediction with reconstructions
        emb2, recon = earth.predict_batch(
            locations=[(28.5, -81.4), (27.9, -82.5)],
            times=["2024-06-15", "2024-07-01"],
            data={
                "temperature": np.array([[22.3], [25.0]]),
                "species": np.array([3, 7]),
            },
            return_reconstructions=True,
        )
        assert emb2.shape == (2, 64)
        assert recon["species"].shape == (2, 10)
        assert recon["spatial"].shape == (2, 3)

        # save/load round trip preserves predictions
        earth.save(str(tmp_path / "model"))
        earth2 = tapi.DeepEarth(hidden_dim=64, n_layers=1,
                                device="cpu").load(str(tmp_path / "model"))
        emb3 = earth2.predict(
            location=(28.5, -81.4),
            time="2024-06-15",
            data={"temperature": [22.3], "species": 3},
        )
        np.testing.assert_allclose(emb, emb3, atol=1e-5)

    def test_register_after_build_raises(self):
        earth = tapi.DeepEarth(hidden_dim=64, n_layers=1, device="cpu")
        earth.register("t", shape=(1,))
        earth.predict((0.0, 0.0), data={"t": [1.0]})
        with pytest.raises(RuntimeError):
            earth.register("late", shape=(2,))

    def test_categorical_requires_classes(self):
        earth = tapi.DeepEarth(device="cpu")
        with pytest.raises(ValueError):
            earth.register("bad", type="categorical")
        with pytest.raises(ValueError):
            earth.register("bad", type="numerical")

    def test_functional_api(self):
        tapi.init(hidden_dim=64, n_layers=1, device="cpu")
        tapi.register("x", shape=(2,))
        emb = tapi.predict((10.0, 20.0), data={"x": [1.0, 2.0]})
        assert emb.shape == (64,)


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.DeepEarth()


def test_seed_makes_the_model_and_same_seed_predicts_alike():
    a, b, c = (register(port_earth(seed=s)) for s in (5, 5, 6))
    ea, eb, ec = (e.predict(**POINT) for e in (a, b, c))
    np.testing.assert_array_equal(ea, eb)
    assert not np.array_equal(ea, ec)


def test_prepared_batch_is_jax_s_on_the_host():
    """xyzt is made in float64 on the host and cast to float32 before the
    copy, so the port's inputs are JAX's bit for bit."""
    j, p = register(japi.DeepEarth()), register(port_earth())
    data = batch_data(2)
    jb = j._prepare_batch(np.asarray(LOCATIONS, np.float64), TIMES, data)
    pb = p._prepare_batch(np.asarray(LOCATIONS, np.float64), TIMES, data)
    np.testing.assert_array_equal(pb["xyzt"].numpy(), np.asarray(jb["xyzt"]))
    assert pb["xyzt"].dtype == torch.float32
    for name, value in jb["modalities"].items():
        np.testing.assert_array_equal(pb["modalities"][name].numpy(),
                                      np.asarray(value))


@pytest.mark.parametrize("t", [None, 0.3, -1.0, 7, "2000-01-01",
                               "2049-12-31T23:00:00", "2100-01-01"])
def test_parse_time_matches_jax(t):
    assert tapi._parse_time(t) == japi._parse_time(t)


class TestFileLoaders:
    def test_npy_npz_csv(self, tmp_path):
        from deepearth_tpu_torch.api import load_file

        a = np.random.default_rng(0).random((4, 3))
        np.save(tmp_path / "x.npy", a)
        np.testing.assert_allclose(load_file(str(tmp_path / "x.npy")), a)
        np.savez(tmp_path / "x.npz", data=a)
        np.testing.assert_allclose(load_file(str(tmp_path / "x.npz")), a)
        with open(tmp_path / "x.csv", "w") as f:
            f.write("a,b\n1.0,2.0\n3.0,4.0\n")
        np.testing.assert_allclose(
            load_file(str(tmp_path / "x.csv")), [[1, 2], [3, 4]]
        )

    def test_geotiff_via_pil_fallback(self, tmp_path):
        from PIL import Image

        from deepearth_tpu_torch.api import load_file

        a = (np.random.default_rng(1).random((6, 5)) * 255).astype(np.uint8)
        Image.fromarray(a).save(tmp_path / "x.tif")
        out = load_file(str(tmp_path / "x.tif"))
        assert out.shape == (1, 6, 5)
        np.testing.assert_array_equal(out[0], a)
        # RGB tiff → (3, H, W)
        rgb = (np.random.default_rng(2).random((4, 4, 3)) * 255).astype(
            np.uint8)
        Image.fromarray(rgb).save(tmp_path / "rgb.tif")
        out = load_file(str(tmp_path / "rgb.tif"))
        assert out.shape == (3, 4, 4)
        np.testing.assert_array_equal(out, japi.load_file(
            str(tmp_path / "rgb.tif")))

    def test_netcdf_via_scipy_fallback(self, tmp_path):
        from scipy.io import netcdf_file

        from deepearth_tpu_torch.api import load_file, load_netcdf

        path = str(tmp_path / "x.nc")
        with netcdf_file(path, "w") as ds:
            ds.createDimension("lat", 3)
            ds.createDimension("lon", 4)
            v = ds.createVariable("temperature", "f4", ("lat", "lon"))
            v[:] = np.arange(12, dtype=np.float32).reshape(3, 4)
        out = load_file(path)
        assert out.shape == (3, 4)
        np.testing.assert_allclose(out.reshape(-1), np.arange(12))
        # explicit variable selection
        np.testing.assert_allclose(
            load_netcdf(path, "temperature"), out
        )
        np.testing.assert_array_equal(out, japi.load_file(path))

    def test_unknown_format_raises(self, tmp_path):
        from deepearth_tpu_torch.api import load_file

        with pytest.raises(ValueError):
            load_file(str(tmp_path / "x.xyz"))


# -- the registry: the port's copies of tests/test_simulator_registry.py ---- #


class TestRegistry:
    def test_adapters(self):
        from deepearth_tpu_torch.registry import (
            timeseries_to_image,
            vector_to_image,
        )

        v = np.arange(10, dtype=np.float32)
        img = vector_to_image(v)
        assert img.shape == (4, 4, 1)
        np.testing.assert_allclose(img.reshape(-1)[:10], v)
        ts = np.ones((6, 3), np.float32)
        assert timeseries_to_image(ts).shape == (6, 3, 1)

    def test_register_and_config_heuristics(self):
        from deepearth_tpu_torch.registry import DataSourceRegistry

        reg = DataSourceRegistry()
        reg.register_data_source("weather", shape=(5,), source_type="vector")
        reg.register_data_source(
            "hyperspectral", shape=(224,), source_type="vector"
        )
        reg.register_data_source(
            "species", source_type="categorical", num_classes=232
        )
        m = reg.modality_config("weather")
        assert not m.use_moe_projection and m.n_tokens == 1
        m = reg.modality_config("hyperspectral")
        assert m.use_moe_projection  # >100 dims → auto MoE
        m = reg.modality_config("species")
        assert m.encoding_type == "learned_embedding"

    def test_validation(self):
        from deepearth_tpu_torch.registry import DataSourceRegistry

        reg = DataSourceRegistry()
        with pytest.raises(ValueError):
            reg.register_data_source("bad", source_type="categorical")
        with pytest.raises(ValueError):
            reg.register_data_source("bad2", shape=(3,), adapter="nope")

    def test_create_model_with_registry(self):
        from deepearth_tpu_torch.configs import tiny_config
        from deepearth_tpu_torch.models import DeepEarthModel
        from deepearth_tpu_torch.registry import (
            DataSourceRegistry,
            create_deepearth_with_registry,
        )

        reg = DataSourceRegistry()
        reg.register_data_source("weather", shape=(5,), source_type="vector")
        reg.register_data_source(
            "species", source_type="categorical", num_classes=50
        )
        base = tiny_config()
        base.modalities.clear()
        model, cfg = create_deepearth_with_registry(reg, base, device="cpu")
        assert isinstance(model, DeepEarthModel)
        assert set(cfg.modalities) == {"weather", "species"}
        assert {p.device.type for p in model.parameters()} == {"cpu"}
        gen = torch.Generator().manual_seed(2)
        batch = {
            "xyzt": torch.rand((2, 4), generator=gen),
            "modalities": {
                "weather": torch.randn((2, 5), generator=gen),
                "species": torch.tensor([1, 2]),
            },
        }
        with torch.inference_mode():
            out = model.eval()(batch)
        assert out["reconstructions"]["weather"].shape == (2, 5)
        assert out["reconstructions"]["species"].shape == (2, 50)


SOURCES = [  # (name, shape, source_type, num_classes, adapter)
    ("weather", (5,), "vector", None, "identity"),
    ("hyperspectral", (224,), "vector", None, "identity"),
    ("big", (40, 40), "vector", None, "vector_to_image"),
    ("scene", (8, 8, 3), "image", None, "identity"),
    ("ndvi", (24, 6), "timeseries", None, "timeseries_to_image"),
    ("species", (), "categorical", 232, "identity"),
]


@pytest.mark.parametrize("source", SOURCES, ids=[s[0] for s in SOURCES])
def test_registry_derives_jax_s_modality_config(source):
    """Each source's derived ModalityConfig and adapter output are the JAX
    registry's."""
    import dataclasses

    from deepearth_tpu.registry import DataSourceRegistry as JaxRegistry
    from deepearth_tpu_torch.registry import DataSourceRegistry

    name, shape, kind, classes, adapter = source
    regs = [JaxRegistry(), DataSourceRegistry()]
    for reg in regs:
        reg.register_data_source(name, shape=shape, source_type=kind,
                                 num_classes=classes, adapter=adapter)
    ref, got = (dataclasses.asdict(r.modality_config(name)) for r in regs)
    assert got == ref
    x = np.random.default_rng(0).standard_normal((2, *shape) or (2,))
    np.testing.assert_array_equal(regs[1].apply_adapter(name, x),
                                  regs[0].apply_adapter(name, x))
