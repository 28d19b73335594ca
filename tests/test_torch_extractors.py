"""The port's frozen-backbone extractors (``data/extractors.py``), its
extraction CLI (``cli/extract_parallel.py``), ``utils/wandb_sink.py`` and
``utils/artifacts.py`` against the JAX package's copies, on the CPU.

The extractors run the same torch backbones: real HF classes built here
with tiny widths (a ``VJEPA2Model`` and a ``LlamaModel`` with a word-level
tokenizer, as ``tests/test_extractors_real.py`` builds them; nothing is
downloaded), so the two packages' features agree bit for bit, as do
``StubExtractor`` and ``run_parallel_extraction``. ``extract`` + ``merge``
write the chunk files and the mmap store byte for byte as
``scripts/extract_parallel.py`` does for the same arguments (the clock
pinned: a zip member carries its write time). ``WandbSink``'s JSONL run
directory is JAX's byte for byte under the same pinned clock.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deepearth_tpu.data import extractors as jext
from deepearth_tpu.utils import artifacts as jartifacts
from deepearth_tpu.utils import wandb_sink as jwandb
from deepearth_tpu_torch.cli import extract_parallel
from deepearth_tpu_torch.data import extractors as text
from deepearth_tpu_torch.utils import artifacts as tartifacts
from deepearth_tpu_torch.utils import wandb_sink as twandb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _VideoProcessorStandIn:
    """VJEPA2VideoProcessor's call interface (the real one needs
    torchvision, absent here): HWC frames -> resized, normalised
    ``pixel_values_videos`` (1, T, C, H, W) in a BatchFeature."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, frames, return_tensors="pt"):
        from transformers import BatchFeature

        vids = []
        for f in frames:
            a = torch.tensor(np.asarray(f), dtype=torch.float32) / 255.0
            a = torch.nn.functional.interpolate(
                a.permute(2, 0, 1)[None], size=(self.size, self.size),
                mode="bilinear", align_corners=False)[0]
            vids.append((a - 0.5) / 0.5)
        return BatchFeature({"pixel_values_videos": torch.stack(vids)[None]},
                            tensor_type=return_tensors)


@pytest.fixture(scope="module")
def tiny_vjepa2():
    from transformers import VJEPA2Config, VJEPA2Model

    cfg = VJEPA2Config(
        patch_size=16, crop_size=64, frames_per_clip=4, tubelet_size=2,
        hidden_size=32, num_attention_heads=2, num_hidden_layers=2,
        pred_hidden_size=32, pred_num_attention_heads=2,
        pred_num_hidden_layers=2, pred_num_mask_tokens=2)
    torch.manual_seed(0)
    return VJEPA2Model(cfg), _VideoProcessorStandIn(64)


@pytest.fixture(scope="module")
def tiny_lm():
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import LlamaConfig, LlamaModel, PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[UNK]": 1}
    for i, w in enumerate("live oak quercus virginiana palmetto florida "
                          "plant tree the a".split()):
        vocab[w] = i + 2
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tokenizer = PreTrainedTokenizerFast(tokenizer_object=tok,
                                        pad_token="[PAD]", unk_token="[UNK]")
    torch.manual_seed(1)
    model = LlamaModel(LlamaConfig(
        vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64))
    return model, tokenizer


IMAGES = [np.random.default_rng(i).integers(0, 255, (80, 96, 3), np.uint8)
          for i in range(3)]
TEXTS = ["live oak quercus virginiana", "florida palmetto",
         "the tree a plant florida oak"]


def test_vjepa2_extractor_matches_jax(tiny_vjepa2):
    model, processor = tiny_vjepa2
    port = text.VJEPA2Extractor(model=model, processor=processor,
                                device="cpu")
    ref = jext.VJEPA2Extractor(model=model, processor=processor)
    got = port.extract_native_embeddings(IMAGES)
    want = ref.extract_native_embeddings(IMAGES)
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (3, 32, 32)
    assert np.array_equal(got, want)
    assert port.get_native_dim() == ref.get_native_dim() == 32
    assert np.array_equal(
        text.run_parallel_extraction(port, IMAGES, n_workers=2,
                                     chunk_size=2),
        jext.run_parallel_extraction(ref, IMAGES, n_workers=2, chunk_size=2))


@pytest.mark.parametrize("pooled", [True, False])
def test_language_extractor_matches_jax(tiny_lm, pooled):
    model, tokenizer = tiny_lm
    for layer in (-1, 1):
        port = text.LanguageModelExtractor(model=model, tokenizer=tokenizer,
                                           device="cpu", layer=layer)
        ref = jext.LanguageModelExtractor(model=model, tokenizer=tokenizer,
                                          layer=layer)
        got = port.extract_native_embeddings(TEXTS, pooled=pooled)
        want = ref.extract_native_embeddings(TEXTS, pooled=pooled)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    enc, jenc = port.tokenize(TEXTS), ref.tokenize(TEXTS)
    assert enc.keys() == jenc.keys()
    assert all(np.array_equal(enc[k], jenc[k]) for k in enc)


def test_extractors_run_on_the_card_unless_asked(tiny_lm):
    """The backbone goes to the card by default; without one the default
    raises and names device='cpu'."""
    model, tokenizer = tiny_lm
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    for make in (lambda: text.LanguageModelExtractor(model=model,
                                                     tokenizer=tokenizer),
                 lambda: text.VJEPA2Extractor(model=model, processor=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("dim,seq_len", [(64, 1), (16, 5)])
def test_stub_and_parallel_extraction_match_jax(dim, seq_len):
    items = [f"item-{i}" for i in range(11)] + [3, ("a", 1)]
    port, ref = (text.StubExtractor(dim, seq_len),
                 jext.StubExtractor(dim, seq_len))
    got = port.extract_native_embeddings(items)
    assert got.dtype == np.float32
    assert np.array_equal(got, ref.extract_native_embeddings(items))
    assert np.array_equal(
        text.run_parallel_extraction(port, items, n_workers=3, chunk_size=4),
        jext.run_parallel_extraction(ref, items, n_workers=3, chunk_size=4))
    assert port.get_native_dim() == dim


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            Path(d, f).read_bytes()
            for d, _, fs in os.walk(root) for f in fs}


def test_extract_and_merge_write_the_jax_files(tmp_path, monkeypatch):
    """Three shards of 10 items, then a merge, by both CLIs with the same
    arguments: the same chunk_<k>.npz files and the same store, byte for
    byte."""
    items = tmp_path / "items.txt"
    items.write_text("".join(f"{100 + i}\tphoto_{i}.jpg\n" for i in range(10))
                     + "\n")
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    script = jax_script("extract_parallel")
    for tag, run in (("port", extract_parallel.main),
                     ("jax", lambda argv: (monkeypatch.setattr(
                         sys, "argv", ["extract_parallel.py", *argv]),
                         script.main()))):
        out = tmp_path / tag
        for k in range(3):
            run(["extract", "--items", str(items), "--out-dir",
                 str(out / "chunks"), "--shard-id", str(k), "--num-shards",
                 "3", "--extractor", "stub", "--batch-size", "2", "--dim",
                 "24"])
        run(["merge", "--out-dir", str(out / "chunks"), "--store",
             str(out / "store" / "vision")])
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(ref) == [
        "chunks/chunk_0.npz", "chunks/chunk_1.npz", "chunks/chunk_2.npz",
        "store/vision.bin", "store/vision.index.npz"]
    for name in port:
        assert port[name] == ref[name], name
    chunk = np.load(tmp_path / "port" / "chunks" / "chunk_1.npz")
    assert list(chunk["ids"]) == [101, 104, 107]
    assert chunk["embeddings"].dtype == np.float16
    with pytest.raises(ValueError, match="unknown extractor"):
        extract_parallel.make_extractor("clip", 8)


def test_wandb_sink_writes_the_jax_run_directory(tmp_path, monkeypatch):
    clock = iter(np.arange(1_700_000_000.0, 1_700_000_100.0, 0.25))
    times = [next(clock) for _ in range(8)]
    metrics = [{"loss/total": 0.125, "obs_per_s": 153.0},
               {"loss/total": np.float32(0.0625), "lr": torch.tensor(3e-4),
                "note": object.__new__(type("Opaque", (), {}))},
               {"acc/species": 0.5}]
    for tag, sink in (("port", twandb.WandbSink), ("jax", jwandb.WandbSink)):
        ticks = iter(times)
        monkeypatch.setattr(time, "time", lambda: next(ticks))
        with sink(project="deepearth", name="run", config={"lr": 3e-4},
                  dir=str(tmp_path / tag), mode="offline") as s:
            assert s.backend == "jsonl"
            s.log(metrics[0])
            s.log(metrics[1], step=10)
            s.log(metrics[2])
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(ref) == ["wandb-history.jsonl",
                                           "wandb-metadata.json"]
    for name in port:
        assert port[name] == ref[name], name
    rows = [json.loads(x) for x in port["wandb-history.jsonl"].splitlines()]
    assert [r["_step"] for r in rows] == [0, 10, 11]
    assert rows[1]["note"].startswith("<") and rows[1]["lr"] == \
        pytest.approx(3e-4)
    with pytest.raises(ImportError, match="wandb"):
        twandb.WandbSink(dir=str(tmp_path / "w"), mode="wandb")


def test_round_stamp_keys_match_jax():
    got, want = tartifacts.round_stamp(), jartifacts.round_stamp()
    assert got.keys() == want.keys() == {"measured_round", "measured_at"}
    assert got["measured_round"] == want["measured_round"] == int(
        open(os.path.join(REPO, "ROUND")).read())
    assert time.strptime(got["measured_at"], "%Y-%m-%dT%H:%M:%SZ")


def test_modules_import_without_jax():
    """The slice's modules import in a process where jax, flax, the JAX
    package and transformers cannot be imported; transformers comes only
    where a checkpoint is fetched by name."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'deepearth_tpu', 'transformers'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from deepearth_tpu_torch.data import StubExtractor\n"
        "from deepearth_tpu_torch.cli import extract_parallel\n"
        "from deepearth_tpu_torch.utils import WandbSink\n"
        "from deepearth_tpu_torch.utils.artifacts import round_stamp\n"
        "from deepearth_tpu_torch.examples import (quick_test, "
        "density_field, florida_pipeline)\n"
        "assert StubExtractor(4).extract_native_embeddings(['a']).shape == "
        "(1, 4)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'deepearth_tpu', 'transformers')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
