"""The port's data layer (``deepearth_tpu_torch.data``, ``utils.logging``)
against the JAX package's modules on the same seeded numpy inputs.

Bit for bit (``np.array_equal``): synthetic batches, ``collate_observations``,
splits, the npy dataset, the native gather (with and without the C
library), ``compress_batch`` and ``decompress_on_device`` in float32 and
bfloat16 (an int8 value and an fp16 scale multiply exactly in float32, and
both sides round the product to bfloat16 once). ``echo_on_device``'s order,
``threaded_producer``'s re-raise and ``device_prefetch``'s pull pattern are
held to JAX's; on the CPU ``device_prefetch`` yields tensors equal to the
numpy leaves, with their dtypes.
"""

import json
import threading
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import deepearth_tpu.data as jdata
import deepearth_tpu.data.native as jnative
import deepearth_tpu.data.pipeline as jpipe
import deepearth_tpu.data.transfer as jtransfer
import deepearth_tpu.evaluation.spatiotemporal as jst
import deepearth_tpu.utils.logging as jlog
import deepearth_tpu_torch.data as tdata
import deepearth_tpu_torch.data.native as tnative
import deepearth_tpu_torch.data.pipeline as tpipe
import deepearth_tpu_torch.data.transfer as ttransfer
import deepearth_tpu_torch.evaluation.spatiotemporal as tst
import deepearth_tpu_torch.utils.logging as tlog

MODALITIES = ("species", "weather", "vision", "language")
SMALL = dict(n_species=17, vision_dim=24, vision_patches=3, language_dim=40)


def assert_tree_equal(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            assert_tree_equal(port[k], ref[k])
        return
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert np.array_equal(port, ref)


def generators(seed=3):
    return (tdata.SyntheticEarthDataGenerator(
                tdata.SyntheticConfig(seed=seed, **SMALL)),
            jdata.SyntheticEarthDataGenerator(
                jdata.SyntheticConfig(seed=seed, **SMALL)))


# --------------------------------------------------------------------------- #
# synthetic data, collation, splits
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bit_for_bit(seed):
    port, ref = generators(seed)
    assert_tree_equal(port.sample_observations(9), ref.sample_observations(9))
    assert_tree_equal(port.sample_observations(5, seed=11),
                      ref.sample_observations(5, seed=11))
    got = list(port.batch_iterator(6, modalities=MODALITIES, steps=3))
    want = list(ref.batch_iterator(6, modalities=MODALITIES, steps=3))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_tree_equal(a, b)
    obs = port.sample_observations(4)
    assert_tree_equal(tdata.observations_to_batch(obs, ("species", "x")),
                      jdata.observations_to_batch(obs, ("species", "x")))
    # batches of fewer modalities draw less noise, with the same values
    for wanted in (("species",), ("species", "weather"), ("language",),
                   ("vision",)):
        for a, b in zip(port.batch_iterator(5, modalities=wanted, steps=2),
                        ref.batch_iterator(5, modalities=wanted, steps=2)):
            assert_tree_equal(a, b)


def test_collate_observations_bit_for_bit():
    port, _ = generators()
    obs = port.sample_observations(5)
    rows = [{k: v[i] for k, v in obs.items()} for i in range(5)]
    assert_tree_equal(tdata.collate_observations(rows, MODALITIES + ("x",)),
                      jdata.collate_observations(rows, MODALITIES + ("x",)))


def test_splits_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    n = 400
    lat = 28.0 + rng.random(n)
    lon = -81.9 + rng.random(n)
    year = rng.integers(2015, 2026, n)
    cfg_t = tdata.SplitConfig(n_spatial_regions=3, region_radius_km=8.0,
                              min_separation_km=12.0, seed=4)
    cfg_j = jdata.SplitConfig(n_spatial_regions=3, region_radius_km=8.0,
                              min_separation_km=12.0, seed=4)
    got = tdata.create_spatial_temporal_split(lat, lon, year, cfg_t)
    want = jdata.create_spatial_temporal_split(lat, lon, year, cfg_j)
    for key in ("train_idx", "spatial_test_idx", "temporal_test_idx"):
        assert np.array_equal(got[key], want[key]), key
    assert got["region_centres"] == want["region_centres"]
    assert len(got["spatial_test_idx"]) > 0
    tdata.save_split(got, str(tmp_path / "port.json"))
    jdata.save_split(want, str(tmp_path / "jax.json"))
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
    back = tdata.load_split(str(tmp_path / "jax.json"))
    for key in ("train_idx", "spatial_test_idx", "temporal_test_idx"):
        assert np.array_equal(back[key], want[key])
    assert back["config"] == cfg_t
    assert np.array_equal(tdata.haversine_km(lat, lon, 28.5, -81.4),
                          jdata.haversine_km(lat, lon, 28.5, -81.4))
    # the evaluation layer delegates to the splits' formula, as JAX's does
    assert np.array_equal(tst.haversine_like(lat, lon, 28.5, -81.4),
                          jst.haversine_like(lat, lon, 28.5, -81.4))


# --------------------------------------------------------------------------- #
# npy dataset, native gather, pipeline
# --------------------------------------------------------------------------- #


def npy_samples(n=7):
    rng = np.random.default_rng(0)
    return [{"id": f"s{i}", "xyzt": rng.random(4),
             "images": rng.random((3, 8, 8)), "input_ids": np.arange(5) + i,
             "modalities": {"weather": rng.random(5)}} for i in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npy_dataset_bit_for_bit(tmp_path, writer):
    """Whichever package writes the layout, both read the same items and
    batches; the port's FIFO cache and truncation behave as JAX's."""
    samples = npy_samples()
    (tdata if writer == "port" else jdata).write_npy_dataset(
        str(tmp_path), "train", samples)
    port = tdata.NpySampleDataset(str(tmp_path), "train", cache_size=3)
    ref = jdata.NpySampleDataset(str(tmp_path), "train", cache_size=3)
    assert len(port) == len(ref) == 7
    for i in range(7):
        a, b = port[i], ref[i]
        assert a.pop("sample_id") == b.pop("sample_id")
        assert_tree_equal(a, b)
    assert len(port._cache) == 3
    got = list(port.batch_iterator(3, modalities=("weather",), seed=5,
                                   steps=3))
    want = list(ref.batch_iterator(3, modalities=("weather",), seed=5,
                                   steps=3))
    for a, b in zip(got, want):
        assert_tree_equal(a, b)
    assert len(tdata.NpySampleDataset(str(tmp_path), "train",
                                      max_samples=3)) == 3


def _blob(tmp_path):
    rng = np.random.default_rng(0)
    blob = rng.standard_normal(4096).astype(np.float16)
    path = tmp_path / "blob.bin"
    blob.tofile(path)
    return np.memmap(path, dtype=np.float16, mode="r")


@pytest.mark.parametrize("native", [True, False], ids=["c", "numpy"])
def test_native_gather_bit_for_bit(tmp_path, monkeypatch, native):
    mm = _blob(tmp_path)
    rows = np.asarray([3, 0, 17, 42, 63, 5, 5, 9, 60, 1], np.int64)
    offsets = rows * 128  # 64 fp16 elements a row
    want = jnative.gather_rows(mm, offsets, 128, n_threads=2)
    if native:
        assert tnative.native_available()
        assert tnative._build_lib().parent == tnative.BUILD_DIR
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
    for threads in (1, 2, 16):
        got = tnative.gather_rows(mm, offsets, 128, n_threads=threads)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    with pytest.raises(ValueError):
        tnative.gather_rows(mm, np.asarray([mm.nbytes - 64]), 128)


def test_pipeline_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"latitude": 28.0 + rng.random(60),
                       "longitude": -81.9 + rng.random(60),
                       "altitude": rng.random(60) * 50,
                       "timestamp": rng.random(60),
                       "species": rng.choice(["a", "b", "c"], 60)})
    df.loc[0, "altitude"] = 1e6
    for frame in (df, df.assign(latitude=df["latitude"] + 100)):
        assert (asdict(tpipe.DatasetLoader().validate(frame))
                == asdict(jpipe.DatasetLoader().validate(frame)))
    path = tmp_path / "obs.csv"
    df.to_csv(path, index=False)
    got_df, got_rep = tpipe.DatasetLoader().load_csv(str(path))
    want_df, want_rep = jpipe.DatasetLoader().load_csv(str(path))
    assert asdict(got_rep) == asdict(want_rep) and got_df.equals(want_df)

    tp, jp = tpipe.DataPreprocessor(2.0), jpipe.DataPreprocessor(2.0)
    kept = tp.remove_outliers(df, ["altitude"])
    assert kept.equals(jp.remove_outliers(df, ["altitude"]))
    assert len(kept) < len(df)
    assert np.array_equal(tp.normalize_coordinates(kept),
                          jp.normalize_coordinates(kept))
    vals = rng.random((60, 3))
    tp.fit_modality("w", vals)
    jp.fit_modality("w", vals)
    assert np.array_equal(tp.transform_modality("w", vals),
                          jp.transform_modality("w", vals))
    tp.fit_modality("s", df["species"].to_numpy(), categorical=True)
    jp.fit_modality("s", df["species"].to_numpy(), categorical=True)
    assert np.array_equal(tp.transform_modality("s", df["species"].to_numpy()),
                          jp.transform_modality("s", df["species"].to_numpy()))

    xyzt = rng.random((120, 4)).astype(np.float32)
    species = rng.integers(0, 5, 120)
    te = tpipe.ContextSamplingEngine(xyzt, species, context_size=16)
    je = jpipe.ContextSamplingEngine(xyzt, species, context_size=16)
    for i in (0, 7, 50):
        assert np.array_equal(te.spatial_neighbors(i, 8),
                              je.spatial_neighbors(i, 8))
        assert np.array_equal(te.temporal_neighbors(i, 8),
                              je.temporal_neighbors(i, 8))
        assert np.array_equal(te.ecological_neighbors(i, 8),
                              je.ecological_neighbors(i, 8))
        assert np.array_equal(te.sample_context(i), je.sample_context(i))


# --------------------------------------------------------------------------- #
# wire compression
# --------------------------------------------------------------------------- #


def raw_batch(seed=0, vision_dtype=np.float32):
    rng = np.random.default_rng(seed)
    vision = (rng.standard_normal((6, 5, 32)) * 3).astype(vision_dtype)
    vision[1, 2] = 0.0  # a zero row: scale 1
    return {"xyzt": rng.random((6, 4)).astype(np.float32),
            "modalities": {
                "species": rng.integers(0, 9, 6).astype(np.int32),
                "vision": vision,
                "language": rng.standard_normal((6, 48)).astype(np.float16),
            }}


@pytest.mark.parametrize("vision_dtype", [np.float32, np.float16])
def test_compress_batch_bit_for_bit(vision_dtype):
    batch = raw_batch(vision_dtype=vision_dtype)
    keys = ("vision", "language", "species", "absent")
    got = ttransfer.compress_batch(batch, keys)
    want = jtransfer.compress_batch(batch, keys)
    assert_tree_equal(got, want)
    # the int leaf passes through untouched
    assert got["modalities"]["species"] is batch["modalities"]["species"]
    q, scale = ttransfer.quantize_rows(batch["modalities"]["vision"])
    assert scale.shape == (6, 5, 1) and scale[1, 2, 0] == 1.0
    assert not q[1, 2].any()
    assert ttransfer.compressed_bytes(got) == jtransfer.compressed_bytes(want)
    assert (ttransfer.compressed_bytes(got)
            < ttransfer.compressed_bytes(batch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decompress_on_device_bit_for_bit(dtype):
    comp = ttransfer.compress_batch(raw_batch(), ("vision", "language"))
    dev = tdata.device_prefetch([comp], device="cpu")
    got = ttransfer.decompress_on_device(next(iter(dev)),
                                         dtype=getattr(torch, dtype))
    want = jtransfer.decompress_on_device(comp, dtype=getattr(jnp, dtype))
    for k in ("vision", "language"):
        g = got["modalities"][k]
        assert g.dtype == getattr(torch, dtype)
        assert np.array_equal(g.float().numpy(),
                              np.asarray(want["modalities"][k], np.float32))
    assert torch.equal(got["modalities"]["species"],
                       torch.from_numpy(comp["modalities"]["species"]))


def test_device_prefetch_compressed_on_the_cpu():
    batches = [raw_batch(seed) for seed in range(3)]
    got = list(ttransfer.device_prefetch_compressed(
        iter(batches), keys=("vision",), device="cpu", dtype=torch.float32))
    assert len(got) == 3
    for g, b in zip(got, batches):
        want = jtransfer.decompress_on_device(
            jtransfer.compress_batch(b, ("vision",)), dtype=jnp.float32)
        assert np.array_equal(g["modalities"]["vision"].numpy(),
                              np.asarray(want["modalities"]["vision"]))
        # an uncompressed float leaf keeps its dtype and bits
        assert np.array_equal(g["modalities"]["language"].numpy(),
                              b["modalities"]["language"])


# --------------------------------------------------------------------------- #
# prefetch, echoing, the threaded producer
# --------------------------------------------------------------------------- #


class Counting:
    """An iterator over ``batches`` that records how many were pulled."""

    def __init__(self, batches):
        self.batches, self.pulled = list(batches), 0

    def __iter__(self):
        for b in self.batches:
            self.pulled += 1
            yield b


def mixed_batch(seed):
    rng = np.random.default_rng(seed)
    return {"xyzt": rng.random((4, 4)).astype(np.float32),
            "modalities": {
                "species": rng.integers(0, 232, 4).astype(np.int32),
                "vision": rng.standard_normal((4, 3, 8)).astype(np.float16),
                "ids": rng.integers(0, 2 ** 40, 4),
            },
            "spatial_mask": rng.random(4) < 0.5}


@pytest.mark.parametrize("size", [1, 2, 3])
def test_device_prefetch_on_the_cpu(size):
    """CPU tensors equal to the numpy leaves, dtypes and nesting kept, in
    order; at most ``size`` batches pulled ahead of the consumer, as JAX's
    prefetch pulls them."""
    batches = [mixed_batch(s) for s in range(5)]
    src, jsrc = Counting(batches), Counting(batches)
    ahead, jahead = [], []
    got = []
    for out in tdata.device_prefetch(iter(src), size=size, device="cpu"):
        got.append(out)
        ahead.append(src.pulled - len(got))
    for _ in jdata.device_prefetch(iter(jsrc), size=size):
        jahead.append(jsrc.pulled - len(jahead) - 1)
    assert ahead == jahead and max(ahead) <= size
    assert len(got) == 5
    for out, b in zip(got, batches):
        assert set(out) == set(b) and set(out["modalities"]) == set(
            b["modalities"])
        for t, x in ((out["xyzt"], b["xyzt"]),
                     (out["spatial_mask"], b["spatial_mask"]),
                     *((out["modalities"][k], b["modalities"][k])
                       for k in b["modalities"])):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.numpy().dtype == x.dtype and np.array_equal(t.numpy(), x)


def test_device_prefetch_refuses_sharding():
    """A sharding that is not the port's (``parallel.Sharding``) is
    refused; ``batch_sharding(mesh)`` places this rank's rows (on one
    process, an abstract mesh: coordinate 0 of 'data')."""
    from deepearth_tpu_torch.parallel import Mesh, batch_sharding

    with pytest.raises(TypeError, match="Sharding"):
        next(tdata.device_prefetch(iter([mixed_batch(0)]), device="cpu",
                                   sharding=object()))
    b = mixed_batch(0)
    out = next(tdata.device_prefetch(
        iter([b]), device="cpu",
        sharding=batch_sharding(Mesh(("data", "model"), (2, 1)))))
    half = b["xyzt"].shape[0] // 2
    np.testing.assert_array_equal(out["xyzt"].numpy(), b["xyzt"][:half])


def test_echo_on_device_order():
    items = [{"i": i} for i in range(4)]
    for factor in (1, 2, 3):
        got = list(tdata.echo_on_device(iter(items), factor))
        want = list(jdata.echo_on_device(iter(items), factor))
        assert got == want and len(got) == 4 * factor
        assert all(a is b for a, b in zip(got, want))
    for mod in (tdata, jdata):
        with pytest.raises(ValueError):
            list(mod.echo_on_device(iter(items), 0))


def test_threaded_producer_order_and_reraise():
    items = [{"i": i} for i in range(9)]
    assert (list(tdata.threaded_producer(lambda: iter(items), capacity=2))
            == list(jdata.threaded_producer(lambda: iter(items), capacity=2))
            == items)

    def failing():
        yield {"i": 0}
        yield {"i": 1}
        raise KeyError("store row missing")

    for mod in (tdata, jdata):
        got = []
        with pytest.raises(KeyError, match="store row missing"):
            for item in mod.threaded_producer(failing):
                got.append(item)
        assert got == [{"i": 0}, {"i": 1}]
    # the worker runs in a thread of its own
    seen = []
    list(tdata.threaded_producer(
        lambda: iter([seen.append(threading.current_thread()) or 1])))
    assert seen[0] is not threading.main_thread()


# --------------------------------------------------------------------------- #
# metric writers
# --------------------------------------------------------------------------- #


def test_metric_writers_match(tmp_path):
    lines = {}
    for name, mod in (("port", tlog), ("jax", jlog)):
        path = tmp_path / name / "m.jsonl"
        w = mod.MultiWriter(mod.JSONLMetricWriter(str(path)), None)
        w.log({"loss": np.float32(0.5), "acc": 1}, step=3)
        w.log({"loss": 0.25}, step=4)
        w.close()
        lines[name] = [json.loads(s) for s in path.read_text().splitlines()]
        for rec in lines[name]:
            assert rec.pop("time") > 0
    assert lines["port"] == lines["jax"] == [
        {"step": 3, "loss": 0.5, "acc": 1.0}, {"step": 4, "loss": 0.25}]


def test_tensorboard_writer(tmp_path):
    pytest.importorskip("tensorboard")
    w = tlog.TensorBoardMetricWriter(str(tmp_path / "tb"))
    w.log({"loss": 0.5}, step=1)
    w.close()
    assert any((tmp_path / "tb").iterdir())


def test_setup_logging_adds_one_handler():
    import io
    import logging

    root = logging.getLogger("DeepEarth")
    saved = root.handlers[:]
    root.handlers.clear()
    try:
        stream = io.StringIO()
        tlog.setup_logging(stream=stream)
        tlog.setup_logging()
        assert len(root.handlers) == 1
        tlog.get_logger("Test").info("hello")
        assert "DeepEarth.Test INFO hello" in stream.getvalue()
    finally:
        root.handlers[:] = saved
