"""The port's command-line entry points (``deepearth_tpu_torch.cli``) on the
CPU, against the JAX package's ``scripts/`` where both can run.

``cli.train`` writes the ``config.json`` that ``scripts/train.py`` writes
for the same arguments (a ``--config`` YAML included); ``Trainer.fit`` with
``echo_factor=2`` is, bit for bit, ``fit`` over each batch repeated twice;
``--resume`` continues from the saved step with the saved state bit for
bit; ``--data-dir`` trains over a parquet file and stores that
``cli.prepare_data`` writes (the same files as ``scripts/prepare_data.py``);
``cli.serve`` answers on port 0; every CLI module imports with JAX blocked.
"""

import copy
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from deepearth_tpu.data import MMapEmbeddingLoader as JaxLoader
from deepearth_tpu_torch import api
from deepearth_tpu_torch.cli import prepare_data, serve, train
from deepearth_tpu_torch.data import (
    MMapEmbeddingLoader,
    SyntheticConfig,
    SyntheticEarthDataGenerator,
    device_prefetch,
)
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.serving import DashboardClient
from deepearth_tpu_torch.training import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--hidden-dim", "32", "--n-layers", "1", "--steps", "2",
        "--batch-size", "8"]


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_train(*argv):
    return train.main([*TINY, "--device", "cpu", "--log-every", "0", *argv])


def test_train_writes_jax_config_json(tmp_path, monkeypatch):
    """The same arguments and YAML give both scripts the same config.json:
    YAML values override the defaults, an explicit argument wins."""
    yaml_path = tmp_path / "train.yaml"
    yaml_path.write_text("learning-rate: 0.0003\nwarmup_steps: 7\n"
                         "hidden-dim: 64\nseed: 2\nunknown_key: 1\n")
    argv = [*TINY, "--log-every", "0", "--config", str(yaml_path)]
    monkeypatch.setattr(sys, "argv",
                        ["train.py", *argv, "--checkpoint-dir",
                         str(tmp_path / "jax")])
    jax_script("train").main()
    train.main([*argv, "--device", "cpu", "--checkpoint-dir",
                str(tmp_path / "port")])
    port_json = (tmp_path / "port" / "config.json").read_text()
    assert port_json == (tmp_path / "jax" / "config.json").read_text()
    args = train.parse_args(argv)
    assert (args.hidden_dim, args.learning_rate, args.warmup_steps,
            args.seed) == (32, 0.0003, 7, 2)


def test_train_defaults_to_the_card():
    assert train.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(TINY)
    with pytest.raises(NotImplementedError, match="item 15"):
        train.main([*TINY, "--device", "cpu", "--distributed"])
    with pytest.raises(SystemExit):
        train.main([*TINY, "--device", "cpu", "--modalities", "sound"])


def tiny_trainer(seed=0):
    args = train.parse_args([*TINY, "--modalities", "species,weather"])
    cfg = train.make_config(args)
    registry = train.synthetic_modalities(SyntheticConfig())
    for name in ("species", "weather"):
        cfg.add_modality(registry[name])
    model = DeepEarthModel(cfg, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    trainer = Trainer(model, cfg, seed=seed)
    return trainer, trainer.init_state()


def test_fit_echo_equals_repeated_batches():
    """fit(echo_factor=2) over n batches on the device is fit over each
    batch repeated twice: the same masks from the same generator, bit for
    bit."""
    gen = SyntheticEarthDataGenerator(SyntheticConfig())
    batches = list(gen.batch_iterator(8, modalities=("species", "weather"),
                                      steps=3))
    echoed, st_e = tiny_trainer()
    repeated, st_r = tiny_trainer()
    st_e, m_e = echoed.fit(st_e, device_prefetch(iter(batches), device="cpu"),
                           6, echo_factor=2, log_every=0)
    twice = [b for b in batches for _ in range(2)]
    st_r, m_r = repeated.fit(st_r, device_prefetch(iter(twice), device="cpu"),
                             6, log_every=0)
    assert st_e.step == st_r.step == 6
    assert m_e == m_r
    for (name, p), q in zip(st_e.model.named_parameters(),
                            st_r.model.parameters()):
        assert torch.equal(p, q), name


def test_resume_continues_from_the_saved_step(tmp_path):
    ckpt = ["--checkpoint-dir", str(tmp_path)]
    first, _ = port_train(*ckpt)
    saved = copy.deepcopy(first.model.state_dict())
    again, metrics = port_train(*ckpt, "--resume", "--steps", "0")
    assert again.step == 2 and metrics == {}
    for name, v in again.model.state_dict().items():
        assert torch.equal(v, saved[name]), name
    more, _ = port_train(*ckpt, "--resume", "--steps", "3",
                         "--metrics-jsonl", str(tmp_path / "m.jsonl"))
    assert more.step == 5
    assert (tmp_path / "step_00000005.pt").exists()
    assert '"step": 5' in (tmp_path / "m.jsonl").read_text()


def write_dataset(tmp_path, n=24):
    """observations.parquet plus vision and language embedding parquets,
    converted to stores by cli.prepare_data."""
    rng = np.random.default_rng(7)
    ids = np.arange(500, 500 + n)
    pd.DataFrame({
        "gbif_id": ids,
        "species": rng.choice(["Quercus", "Pinus", "Acer", "Sabal"], n),
        "latitude": 28.03 + rng.random(n) * 0.9,
        "longitude": -81.93 + rng.random(n),
        "year": rng.integers(2010, 2026, n),
        "month": rng.integers(1, 13, n),
    }).to_parquet(tmp_path / "observations.parquet")
    shapes = {"vision": (20, 8), "language": (16,)}
    for store, shape in shapes.items():
        emb = rng.standard_normal((n, int(np.prod(shape)))).astype(np.float32)
        pd.DataFrame({"gbif_id": ids, "embedding": list(emb)}).to_parquet(
            tmp_path / f"{store}.parquet")
        prepare_data.main([
            "--input", str(tmp_path / f"{store}.parquet"),
            "--shape", *map(str, shape), "--output", str(tmp_path / store),
            "--batch-rows", "10"])
    return ids, shapes


def test_prepare_data_writes_the_jax_store(tmp_path, monkeypatch):
    ids, shapes = write_dataset(tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "prepare_data.py", "--input", str(tmp_path / "vision.parquet"),
        "--shape", "20", "8", "--output", str(tmp_path / "jax_vision"),
        "--batch-rows", "10"])
    jax_script("prepare_data").main()
    assert ((tmp_path / "vision.bin").read_bytes()
            == (tmp_path / "jax_vision.bin").read_bytes())
    port, ref = MMapEmbeddingLoader(str(tmp_path / "vision")), JaxLoader(
        str(tmp_path / "vision"))
    assert port.embedding_shape == ref.embedding_shape == shapes["vision"]
    got, found = port.get_batch(ids[::3].tolist(), out_dtype=np.float16)
    want, jfound = ref.get_batch(ids[::3].tolist(), out_dtype=np.float16)
    assert found.all() and jfound.all() and np.array_equal(got, want)


def test_train_on_a_data_dir(tmp_path):
    write_dataset(tmp_path)
    state, metrics = port_train("--data-dir", str(tmp_path))
    assert state.step == 2 and np.isfinite(metrics["loss/total"])
    model = state.model
    assert {"species", "vision", "language"} == set(model.config.modalities)
    # the encoder's position table is sized by the store's 20 patches
    assert model.encoder_vision.position_embedding.shape[-2] == 20


def test_serve_answers_on_port_zero(tmp_path):
    write_dataset(tmp_path)
    server = serve.start([
        "--port", "0", "--with-predictor", "--device", "cpu",
        "--observations", str(tmp_path / "observations.parquet"),
        "--vision-store", str(tmp_path / "vision")])
    try:
        client = DashboardClient(f"http://127.0.0.1:{server.port}")
        health = client.health()
        assert health["status"] == "healthy"
        assert health["n_observations"] == 24
        assert health["vision_store"]["n"] == 24
        assert client.observations()["count"] == 24
        got = client.predict((28.5, -81.4), "2024-06-15", {"species": 3})
    finally:
        server.stop()
    earth = api.DeepEarth(device="cpu")
    earth.register("species", type="categorical", num_classes=232)
    want = earth.predict((28.5, -81.4), "2024-06-15", {"species": 3})
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_cli_modules_import_without_jax():
    """The three CLIs and the data, geospatial and logging modules import
    with JAX and the JAX package blocked, the train CLI runs a step, and
    neither pandas-free imports nor tensorboard are pulled in eagerly."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'deepearth_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from deepearth_tpu_torch.cli import prepare_data, serve, train\n"
        "import deepearth_tpu_torch.data.pipeline\n"
        "import deepearth_tpu_torch.data.native\n"
        "import deepearth_tpu_torch.geospatial\n"
        "import deepearth_tpu_torch.utils\n"
        "assert 'tensorboard' not in sys.modules\n"
        "assert 'yaml' not in sys.modules and 'sklearn' not in sys.modules\n"
        "state, _ = train.main(['--device', 'cpu', '--hidden-dim', '32',\n"
        "    '--n-layers', '1', '--steps', '1', '--batch-size', '4',\n"
        "    '--log-every', '0'])\n"
        "assert state.step == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepearth_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
