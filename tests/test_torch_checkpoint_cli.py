"""The port's checkpoint CLIs (``cli.convert_checkpoint``, ``cli.generate``)
and their file formats against the JAX package's scripts, on the CPU.

A tiny HF DeepSeek-V3-style checkpoint (hidden 32, 2 heads of q 24 = nope 16
+ rope 8 and v 16, q-LoRA 16, kv-LoRA 16; layer 0 dense, layer 1 MoE with 4
routed experts and a shared one) made from a numpy seed, saved as a bare
torch state file and as a ``.safetensors`` directory (written by the
safetensors package, read by the port's own reader). The converted trees
are compared exactly (both packages cast the same values to float32); the
two packages' ``params.msgpack`` bytes are compared exactly (the port writes
flax's layout without flax); greedy tokens exactly.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from safetensors.torch import save_file

from deepearth_tpu.models import hf_convert as jconvert
from deepearth_tpu.models.generation import generate as jgenerate
from deepearth_tpu.serving.language_server import HashEmbedder
from deepearth_tpu_torch.cli import convert_checkpoint as tconvert
from deepearth_tpu_torch.cli import generate as tgenerate
from deepearth_tpu_torch.utils import checkpoint_files

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 97
HF_CONFIG = {
    "hidden_size": 32, "num_attention_heads": 2, "num_hidden_layers": 2,
    "q_lora_rank": 16, "kv_lora_rank": 16, "qk_rope_head_dim": 8,
    "qk_nope_head_dim": 16, "v_head_dim": 16, "intermediate_size": 48,
    "moe_intermediate_size": 24, "n_routed_experts": 4,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "n_group": 1,
    "topk_group": 1, "routed_scaling_factor": 1.0, "norm_topk_prob": True,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "rms_norm_eps": 1e-6,
    "vocab_size": VOCAB, "max_position_embeddings": 256,
    "rope_theta": 10000.0, "rope_scaling": None,
}


def hf_shapes(c):
    """Parameter name -> shape of an HF DeepseekV3ForCausalLM."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qh = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    out = {"model.embed_tokens.weight": (c["vocab_size"], d),
           "model.norm.weight": (d,), "lm_head.weight": (c["vocab_size"], d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.update({
            f"{p}.input_layernorm.weight": (d,),
            f"{p}.post_attention_layernorm.weight": (d,),
            f"{p}.self_attn.q_a_proj.weight": (c["q_lora_rank"], d),
            f"{p}.self_attn.q_a_layernorm.weight": (c["q_lora_rank"],),
            f"{p}.self_attn.q_b_proj.weight": (h * qh, c["q_lora_rank"]),
            f"{p}.self_attn.kv_a_proj_with_mqa.weight": (
                c["kv_lora_rank"] + c["qk_rope_head_dim"], d),
            f"{p}.self_attn.kv_a_layernorm.weight": (c["kv_lora_rank"],),
            f"{p}.self_attn.kv_b_proj.weight": (
                h * (c["qk_nope_head_dim"] + c["v_head_dim"]),
                c["kv_lora_rank"]),
            f"{p}.self_attn.o_proj.weight": (d, h * c["v_head_dim"]),
        })
        if i < c["first_k_dense_replace"]:
            mlps = {f"{p}.mlp": c["intermediate_size"]}
        else:
            e, f = c["n_routed_experts"], c["moe_intermediate_size"]
            out[f"{p}.mlp.gate.weight"] = (e, d)
            out[f"{p}.mlp.gate.e_score_correction_bias"] = (e,)
            mlps = {f"{p}.mlp.experts.{j}": f for j in range(e)}
            mlps[f"{p}.mlp.shared_experts"] = f * c["n_shared_experts"]
        for m, f in mlps.items():
            out.update({f"{m}.gate_proj.weight": (f, d),
                        f"{m}.up_proj.weight": (f, d),
                        f"{m}.down_proj.weight": (d, f)})
    return out


def hf_state_dict(seed=0):
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(
        (0.1 * rng.standard_normal(shape)).astype(np.float32))
        for name, shape in hf_shapes(HF_CONFIG).items()}


def jax_script(name):
    """One of the JAX package's scripts, imported by path (tests only)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same state dict as a bare torch file (with its config beside) and
    as an HF directory of .safetensors + config.json."""
    root = tmp_path_factory.mktemp("hf")
    sd = hf_state_dict()
    torch.save(sd, root / "state.pt")
    (root / "config.json").write_text(json.dumps(HF_CONFIG))
    hf_dir = root / "hf"
    hf_dir.mkdir()
    save_file(sd, str(hf_dir / "model.safetensors"))
    (hf_dir / "config.json").write_text(json.dumps(HF_CONFIG))
    return root


@pytest.mark.parametrize("source", ["pt", "safetensors"])
def test_convert_matches_jax_and_either_reads_the_other(checkpoints,
                                                        tmp_path, source):
    if source == "pt":
        argv = [str(checkpoints / "state.pt"), str(tmp_path / "port"),
                "--config", str(checkpoints / "config.json")]
    else:
        argv = [str(checkpoints / "hf"), str(tmp_path / "port")]
    params, cfg, vocab = tconvert.main(argv + ["--verify", "--device",
                                               "cpu"])
    jparams, jcfg, jvocab = jconvert.load_hf_checkpoint(
        *argv[:1], None if source == "safetensors" else HF_CONFIG)
    assert vocab == jvocab == VOCAB
    assert_trees_equal(params, jparams)

    script = jax_script("convert_checkpoint")
    # JAX's loader reads the port's directory ...
    got, got_cfg, got_vocab = script.load_converted(str(tmp_path / "port"))
    assert_trees_equal(got, jparams)
    assert got_cfg == jcfg and got_vocab == VOCAB
    # ... the port's reads JAX's, and the two params.msgpack are one file
    script.save_converted(str(tmp_path / "jax"), jparams, jcfg, jvocab)
    back, back_cfg, back_vocab = tconvert.load_converted(str(tmp_path / "jax"))
    assert_trees_equal(back, jparams)
    assert back_cfg == cfg and back_vocab == VOCAB
    for name in ("params.msgpack", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_chunked_arrays_round_trip(tmp_path, monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes are split as flax splits them (the
    limit made small on both sides): each package reads the other's file."""
    monkeypatch.setattr(checkpoint_files, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(3)
    tree = {"embed_tokens": {"embedding": rng.standard_normal(
                (97, 32)).astype(np.float32)},
            "small": {"bias": rng.standard_normal((5,)).astype(np.float32)},
            "bf16": {"kernel": rng.standard_normal((40, 30)).astype(
                jnp.bfloat16)}}
    checkpoint_files.write_msgpack_tree(tmp_path / "port.msgpack", tree)
    data = (tmp_path / "port.msgpack").read_bytes()
    assert data == serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert_trees_equal(serialization.msgpack_restore(data), tree)
    back = checkpoint_files.read_msgpack_tree(tmp_path / "port.msgpack")
    tree["bf16"]["kernel"] = tree["bf16"]["kernel"].astype(np.float32)
    assert_trees_equal(back, tree)


def test_generate_matches_jax_greedy(checkpoints, tmp_path):
    tconvert.main([str(checkpoints / "hf"), str(tmp_path), "--device",
                   "cpu"])
    prompt = "live oak grows near the salt marsh"
    toks = tgenerate.main([str(tmp_path), "--prompt", prompt,
                           "--max-new-tokens", "8", "--device", "cpu"])
    params, cfg, vocab = jax_script("convert_checkpoint").load_converted(
        str(tmp_path))
    ids = [t % vocab for t in HashEmbedder().tokenize(prompt)]
    ref = jgenerate(jax.tree.map(jnp.asarray, params), cfg,
                    jnp.asarray([ids], jnp.int32), max_new_tokens=8)
    assert toks == np.asarray(ref)[0].tolist()
    assert len(toks) == 8


def test_checkpoint_cli_modules_import_and_run_without_jax(tmp_path):
    """Both CLIs import and run with JAX, flax, msgpack, safetensors and the
    JAX package blocked: a .safetensors checkpoint (written here, by the
    safetensors package) converts, verifies and decodes on the CPU."""
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    save_file(hf_state_dict(1), str(hf_dir / "model.safetensors"))
    (hf_dir / "config.json").write_text(json.dumps(HF_CONFIG))
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'deepearth_tpu', 'msgpack',\n"
        "          'safetensors', 'transformers'):\n"
        "    sys.modules[m] = None\n"
        "from deepearth_tpu_torch.cli import convert_checkpoint, generate\n"
        f"root = {str(tmp_path)!r}\n"
        "convert_checkpoint.main([root + '/hf', root + '/out', '--verify',\n"
        "                         '--device', 'cpu'])\n"
        "toks = generate.main([root + '/out', '--prompt', 'live oak',\n"
        "                      '--max-new-tokens', '4', '--device', 'cpu'])\n"
        "assert len(toks) == 4\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'deepearth_tpu', 'msgpack', 'safetensors') and "
        "sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "verify OK" in proc.stdout
    assert proc.stdout.strip().endswith("ok")
