"""The port's language server (``serving/language_server.py``) and HF
checkpoint conversion (``models/hf_convert.py``) against the JAX package's,
on the CPU.

No checkpoint, config.json or tokenizer is downloaded: the HF state dict is
written, under HF's names, from a random port model, and the HF config is a
dict written here. Tolerances: embeddings 1e-5 of the largest entry (both
packages compute the stack in fp32, whatever the stored type); tokens equal.
"""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu.models import hf_convert as jhf
from deepearth_tpu.serving import language_server as jls
from deepearth_tpu_torch import flax_params_from_model, load_flax_params
from deepearth_tpu_torch.models import DeepSeekForCausalLM, hf_convert
from deepearth_tpu_torch.serving import language_server as tls

torch.set_num_threads(2)

REL = 1e-5

HF_CONFIG = dict(
    vocab_size=256, hidden_size=128, intermediate_size=256,
    moe_intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_shared_experts=1, n_routed_experts=8,
    routed_scaling_factor=1.0, num_experts_per_tok=2, n_group=2,
    topk_group=1, norm_topk_prob=True, first_k_dense_replace=1,
    moe_layer_freq=1, q_lora_rank=128, kv_lora_rank=64, qk_rope_head_dim=16,
    qk_nope_head_dim=32, v_head_dim=32, max_position_embeddings=256,
    rms_norm_eps=1e-6, attention_bias=False, attention_dropout=0.0,
    rope_theta=10000.0, tie_word_embeddings=False)


def hf_state_dict(model) -> dict:
    """The port model's parameters under HF DeepseekV3ForCausalLM names."""
    cfg = model.cfg
    sd = {"model.embed_tokens.weight": model.embed_tokens.weight,
          "model.norm.weight": model.model.norm.weight,
          "lm_head.weight": model.lm_head.weight}
    for i in range(cfg.n_layers):
        layer, pre = getattr(model.model, f"layer_{i}"), f"model.layers.{i}"
        for name, p in layer.named_parameters():
            if name.startswith("moe."):
                continue
            sd[f"{pre}.{name}"] = p  # the port's names are HF's
        if hasattr(layer, "moe"):
            moe = layer.moe
            sd[f"{pre}.mlp.gate.weight"] = moe.router_weight
            sd[f"{pre}.mlp.gate.e_score_correction_bias"] = \
                moe.e_score_correction_bias
            for j in range(cfg.moe.n_routed_experts):
                for proj, w in (("gate_proj", moe.w_gate), ("up_proj",
                                                            moe.w_up),
                                ("down_proj", moe.w_down)):
                    sd[f"{pre}.mlp.experts.{j}.{proj}.weight"] = w[j].T
            for name, p in moe.shared_experts.named_parameters():
                sd[f"{pre}.mlp.shared_experts.{name}"] = p
    return {k: v.detach().clone() for k, v in sd.items()}


@pytest.fixture(scope="module")
def hf():
    cfg, vocab = hf_convert.config_from_hf(HF_CONFIG)
    model = DeepSeekForCausalLM(cfg, vocab,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu", tie_embeddings=False)
    with torch.no_grad():  # a nonzero router bias exercises its path
        for m in model.modules():
            if hasattr(m, "e_score_correction_bias"):
                m.e_score_correction_bias.uniform_(
                    -0.05, 0.05, generator=torch.Generator().manual_seed(1))
    sd = hf_state_dict(model)
    jcfg, _ = jhf.config_from_hf(HF_CONFIG)
    return cfg, jcfg, vocab, model, sd


def _same_tree(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _same_tree(got[k], ref[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]))


# --------------------------------------------------------------------------- #
# HF conversion
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rope", [None, "yarn"])
def test_config_from_hf_matches_jax(rope):
    d = dict(HF_CONFIG)
    if rope:
        d["rope_scaling"] = {"type": "yarn", "factor": 4.0,
                             "original_max_position_embeddings": 64,
                             "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
                             "mscale_all_dim": 0.7}
    cfg, vocab = hf_convert.config_from_hf(d)
    jcfg, jvocab = jhf.config_from_hf(d)
    assert vocab == jvocab == 256
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    for key in ("mla", "moe"):
        ref_sub, sub = want.pop(key), got.pop(key)
        assert {k: sub[k] for k in ref_sub} == ref_sub
    assert {k: got[k] for k in want} == want
    assert cfg.moe.capacity_factor is None and cfg.mla.max_position_embeddings == 256


def test_convert_hf_state_dict_matches_jax_and_loads(hf):
    cfg, jcfg, vocab, model, sd = hf
    tree = hf_convert.convert_hf_state_dict(sd, cfg)
    _same_tree(tree, jhf.convert_hf_state_dict(sd, jcfg))
    fresh = DeepSeekForCausalLM(cfg, vocab,
                                generator=torch.Generator().manual_seed(5),
                                device="cpu", tie_embeddings=False)
    load_flax_params(fresh, tree)
    _same_tree(flax_params_from_model(fresh), flax_params_from_model(model))
    tied = hf_convert.convert_hf_state_dict(sd, cfg, tie_embeddings=True)
    assert "lm_head" not in tied


def test_load_hf_model_from_a_directory(hf, tmp_path):
    cfg, _, vocab, model, sd = hf
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIG))
    loaded, lcfg, lvocab = hf_convert.load_hf_model(str(tmp_path),
                                                    device="cpu")
    assert lvocab == vocab and not loaded.tie_embeddings
    _same_tree(flax_params_from_model(loaded), flax_params_from_model(model))
    with pytest.raises(ValueError, match="hf_config required"):
        hf_convert.load_hf_checkpoint(str(tmp_path / "pytorch_model.bin"))


# --------------------------------------------------------------------------- #
# the embedders
# --------------------------------------------------------------------------- #

TEXTS = ["quercus virginiana in florida", "live oak", "", "a b c d e f"]


def test_hash_embedder_matches_jax():
    for dim in (16, 7168):
        ref, ours = jls.HashEmbedder(dim), tls.HashEmbedder(dim)
        for text in TEXTS:
            assert ours.tokenize(text) == ref.tokenize(text)
            np.testing.assert_array_equal(ours.embed(text), ref.embed(text))


def _tiny_hf_checkpoint(path):
    """A word-level tokenizer and a 2-layer random Llama, written to a
    local directory (nothing is downloaded)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import LlamaConfig, LlamaModel, PreTrainedTokenizerFast

    words = "quercus virginiana in florida live oak a b c d e f".split()
    vocab = {"[PAD]": 0, "[UNK]": 1, **{w: i + 2 for i, w in enumerate(words)}}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]",
                            unk_token="[UNK]").save_pretrained(path)
    torch.manual_seed(0)
    LlamaModel(LlamaConfig(
        vocab_size=len(vocab), hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4)).save_pretrained(path)


def test_hf_embedder_on_the_card_unless_asked(tmp_path, monkeypatch):
    """HFEmbedder defaults to the card, as every entry point of the port;
    with device="cpu" it gives the JAX package's HFEmbedder's tokens and
    vectors on the same local checkpoint."""
    from huggingface_hub import constants as hub_constants

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    assert inspect.signature(tls.HFEmbedder).parameters["device"].default \
        == "cuda"
    _tiny_hf_checkpoint(tmp_path)
    ours = tls.HFEmbedder(str(tmp_path), device="cpu")
    ref = jls.HFEmbedder(str(tmp_path), device="cpu")
    assert ours.dim == ref.dim == 48
    assert next(ours.model.parameters()).device.type == "cpu"
    for text in TEXTS[:2]:
        assert ours.tokenize(text) == ref.tokenize(text)
        got = ours.embed(text)
        assert got.dtype == np.float32 and got.shape == (48,)
        np.testing.assert_array_equal(got, ref.embed(text))
    if not torch.cuda.is_available():  # the default asks for the card
        with pytest.raises((AssertionError, RuntimeError)):
            tls.HFEmbedder(str(tmp_path))


@pytest.fixture(scope="module")
def embedders(hf):
    cfg, jcfg, vocab, model, sd = hf
    params = jhf.convert_hf_state_dict(sd, jcfg)
    ref = jls.DeepSeekFlaxEmbedder(params, jcfg, vocab, quantize_int8=True,
                                   quant_min_dim=128)
    ours = tls.DeepSeekEmbedder(model, quantize_int8=True, quant_min_dim=128)
    return ref, ours


def test_bucketing_and_max_prompt_match_jax(embedders):
    ref, ours = embedders
    # the block config has no max_position_embeddings (it is on cfg.mla):
    # both packages fall back to the service cap
    assert ours._max_prompt() == ref._max_prompt() == 2048
    for n in (1, 3, 64, 65, 300, 2048, 2049, 5000):
        ids = list(range(n))
        assert ours._bucket_prompt(ids) == ref._bucket_prompt(ids)
    assert ours.tokenize("live oak") == ref.tokenize("live oak")


def test_embed_matches_jax(embedders):
    ref, ours = embedders
    for text in TEXTS[:2]:
        want = ref.embed(text)
        got = ours.embed(text)
        assert got.dtype == np.float32 and got.shape == want.shape == (128,)
        np.testing.assert_allclose(got, want,
                                   atol=REL * np.abs(want).max(), rtol=0)


def test_embed_computes_in_fp32_over_bf16_params(hf):
    cfg, jcfg, vocab, model, sd = hf
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
        jhf.convert_hf_state_dict(sd, jcfg))
    ref = jls.DeepSeekFlaxEmbedder(params, jcfg, vocab)
    bf16 = DeepSeekForCausalLM(cfg, vocab,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu", tie_embeddings=False,
                               compute_dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    load_flax_params(bf16, params)
    ours = tls.DeepSeekEmbedder(bf16)
    want = ref.embed(TEXTS[0])
    np.testing.assert_allclose(ours.embed(TEXTS[0]), want,
                               atol=REL * np.abs(want).max(), rtol=0)
    assert all(m.compute_dtype == torch.bfloat16 for m in bf16.modules()
               if hasattr(m, "compute_dtype"))


def test_int8_generation_matches_jax(embedders):
    ref, ours = embedders
    assert hasattr(ours.gen_model.lm_head, "kernel_q")
    assert hasattr(ours.model.lm_head, "weight")  # embeddings stay plain
    want = ref.generate("live oak", max_new_tokens=5)
    got = ours.generate("live oak", max_new_tokens=5)
    assert got == want and len(got) == 5


def test_server_round_trip_on_localhost(embedders):
    _, ours = embedders
    srv = tls.LanguageServer(tls.LanguageEmbeddingService(ours)).start()
    try:
        c = tls.LanguageClient(f"http://127.0.0.1:{srv.port}", timeout=120)
        h = c.health()
        assert h["backend"] == "DeepSeekEmbedder" and h["dim"] == 128
        v = c.embed("quercus virginiana in florida")
        np.testing.assert_allclose(v, ours.embed(
            "quercus virginiana in florida"), rtol=1e-6)
        assert c.embed(["a", "b"]).shape == (2, 128)
        assert c.tokenize("live oak") == ours.tokenize("live oak")
        assert c.generate("live oak", max_new_tokens=3) == ours.generate(
            "live oak", max_new_tokens=3)
        sampled = c.generate("live oak", max_new_tokens=3, temperature=1.0)
        assert len(sampled) == 3 and all(0 <= t < 256 for t in sampled)
    finally:
        srv.stop()
    hashed = tls.LanguageEmbeddingService(tls.HashEmbedder(8))
    with pytest.raises(ValueError, match="cannot generate"):
        hashed.generate("x")
