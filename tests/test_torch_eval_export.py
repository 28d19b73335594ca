"""The port's evaluation probes, export, profiling and resource monitor
(``evaluation/probes.py``, ``export.py``, ``utils/profiling.py``,
``utils/monitor.py``) against the JAX package's modules, on the CPU.

Limits: the linear probe, its one random draw (the initial W) pinned to the
same numbers on both sides, gives held-out predictions within 1e-4 of
JAX's (300 Adam steps in fp32, sums in another order); the metric functions
are numpy copies and agree exactly. The exported programs of a tiny
DeepEarthModel, reloaded, give the eager port's outputs exactly (the same
ATen operations on the same inputs) and JAX's exported StableHLO program's
within 1e-5 in fp32. Export on the card (every forward kernel a custom
operator, the refusal of the backward kernels) is held by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``; here the
dispatch under an export trace is checked on fake CUDA tensors.
"""

import json
import os
import re
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from deepearth_tpu import configs as jcfg
from deepearth_tpu import export as jexport
from deepearth_tpu.evaluation import probes as jprobes
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.utils import monitor as jmonitor
from deepearth_tpu.utils import profiling as jprofiling
from deepearth_tpu_torch import export as texport
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import config_from_json
from deepearth_tpu_torch.convert import load_flax_params
from deepearth_tpu_torch.evaluation import probes as tprobes
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.utils import monitor as tmonitor
from deepearth_tpu_torch.utils import profiling as tprofiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- probes ------------------------------------------------------------------ #


def probe_data(kind, seed=0, n=120, d=12):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + 2.0
    w = rng.normal(size=(d, 3))
    if kind == "classification":
        return feats, (feats @ w).argmax(-1), 3
    return feats, feats @ w[:, :2] + 0.1 * rng.normal(size=(n, 2)), 0


@pytest.mark.parametrize("kind", ["regression", "classification"])
def test_probe_matches_jax(monkeypatch, kind):
    feats, targets, n_classes = probe_data(kind)
    out_dim = n_classes or targets.shape[1]
    w0 = np.random.default_rng(1).normal(size=(feats.shape[1], out_dim))
    w0 = w0.astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(w0).reshape(shape))
    monkeypatch.setattr(tprobes, "_init_weight",
                        lambda shape, seed, device: torch.tensor(w0) * 0.01)
    kw = dict(n_classes=n_classes, steps=150, seed=3)
    jpred, jtrue = jprobes._train_linear_probe(feats, targets, kind, **kw)
    tpred, ttrue = tprobes._train_linear_probe(feats, targets, kind,
                                               device="cpu", **kw)
    np.testing.assert_array_equal(ttrue, np.asarray(jtrue))
    np.testing.assert_allclose(tpred, np.asarray(jpred), rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jpred).max()))


def test_metric_functions_are_exact_copies():
    rng = np.random.default_rng(2)
    pred, true = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    assert (tprobes.regression_metrics(pred, true)
            == jprobes.regression_metrics(pred, true))
    logits, labels = rng.normal(size=(80, 5)), rng.integers(0, 5, 80)
    assert (tprobes.classification_metrics(logits, labels)
            == jprobes.classification_metrics(logits, labels))


def test_evaluator_trains_on_the_cpu_when_asked():
    feats, labels, n_classes = probe_data("classification", seed=4)
    ev = tprobes.DeepEarthEvaluator(lambda b: b["x"], device="cpu")
    got = ev.extract([{"x": feats[:60]}, {"x": feats[60:]}])
    np.testing.assert_array_equal(got, feats)
    res = ev.evaluate_classification(got, labels, n_classes, steps=50)
    assert res.kind == "classification"
    assert set(res.metrics) == {"accuracy", "f1_macro"}
    reg = ev.evaluate_regression(*probe_data("regression")[:2], steps=50)
    assert set(reg.metrics) == {"rmse", "r2"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tprobes.DeepEarthEvaluator(lambda b: b)


# -- export ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def export_pair():
    """JAX's export test model (tests/test_models.py TestExport) in fp32,
    and the port loaded with its parameters; one numpy batch."""
    cfg = jcfg.tiny_config(compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(name="vision", input_dim=32,
                                         n_tokens=2, encoder_layers=1,
                                         encoder_heads=4))
    rng = np.random.default_rng(0)
    batch = {"xyzt": rng.uniform(0, 1, (2, 4)).astype(np.float32),
             "modalities": {
                 "species": rng.integers(0, 232, 2).astype(np.int32),
                 "vision": rng.normal(size=(2, 4, 32)).astype(np.float32)}}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jmodel = JaxModel(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jbatch)["params"]
    model = DeepEarthModel(config_from_json(jcfg.config_to_json(cfg)),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens={"vision": 4})
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    tbatch = {"xyzt": torch.from_numpy(batch["xyzt"]), "modalities": {
        k: torch.from_numpy(v) for k, v in batch["modalities"].items()}}
    jfused, jrecon = jexport.load_exported(
        jexport.export_forward(jmodel, params, jbatch))(params, jbatch)
    return model, tbatch, np.asarray(jfused), jax.tree_util.tree_map(
        np.asarray, jrecon)


def check_outputs(got, eager, jax_out):
    (fused, recon), (efused, erecon), (jfused, jrecon) = got, eager, jax_out
    assert torch.equal(fused, efused)
    assert recon.keys() == erecon.keys() == jrecon.keys()
    for k in recon:
        assert torch.equal(recon[k], erecon[k]), k
    np.testing.assert_allclose(fused.numpy(), jfused, rtol=0, atol=1e-5)
    for k in recon:
        np.testing.assert_allclose(recon[k].numpy(), jrecon[k], rtol=0,
                                   atol=1e-5)


def eager(model, batch):
    with torch.no_grad():
        out = model.eval()(batch)
    return out["fused_representation"], out["reconstructions"]


def test_export_forward_roundtrip_matches_eager_and_jax(export_pair):
    model, batch, jfused, jrecon = export_pair
    params = {k: v.detach() for k, v in model.named_parameters()}
    blob = texport.export_forward(model, params, batch)
    assert isinstance(blob, bytes) and len(blob) > 1000
    fn = texport.load_exported(blob)
    check_outputs(fn(params, batch), eager(model, batch), (jfused, jrecon))
    # the parameters are an argument: other values give other outputs
    doubled = {k: v * 2 for k, v in params.items()}
    assert not torch.equal(fn(doubled, batch)[0], fn(params, batch)[0])


def test_export_model_forward_bakes_the_weights(export_pair):
    model, batch, jfused, jrecon = export_pair
    blob = texport.export_model_forward(model, None, batch)
    fn = texport.load_exported(blob)
    check_outputs(fn(batch), eager(model, batch), (jfused, jrecon))
    with pytest.raises(ValueError, match="not parameters"):
        texport.export_model_forward(model, {"nope": torch.zeros(1)}, batch)


def test_export_model_forward_leaves_the_model_as_it_was(export_pair):
    """Other weights are baked into the program, not written into the
    model; a params dict lacking any of the model's parameters raises."""
    model, batch, _, _ = export_pair
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = {k: v.detach() for k, v in model.named_parameters()}
    doubled = {k: v * 2 for k, v in params.items()}
    fn = texport.load_exported(
        texport.export_model_forward(model, doubled, batch))
    after = model.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    with torch.no_grad():
        want = torch.func.functional_call(model.eval(), doubled, (batch,))
    fused, recon = fn(batch)
    assert torch.equal(fused, want["fused_representation"])
    assert all(torch.equal(recon[k], want["reconstructions"][k])
               for k in want["reconstructions"])
    assert not torch.equal(fused, eager(model, batch)[0])
    first = next(iter(params))
    for export in (texport.export_model_forward, texport.export_forward):
        with pytest.raises(ValueError,
                           match="missing: " + re.escape(str([first]))):
            export(model, {k: v for k, v in params.items() if k != first},
                   batch)


def test_export_dispatch_under_a_trace_on_fake_cuda_tensors():
    """Under an export trace the forward kernels call their registered
    operators (the fake implementations give the shapes): K1-fwd, K2-fwd's
    Grid4D encode and per-table kernel, K6 and K8 here (every forward
    operator in tests/test_torch_export_ops.py); a backward kernel's
    launch (K5-bwd's split here) raises ValueError: an exported program is
    an inference program."""
    with FakeTensorMode(), mock.patch.object(torch.compiler, "is_exporting",
                                             lambda: True):
        q = torch.empty((3, 4, 64), device="cuda")
        assert kernels.pairwise_attention_fwd(q, q, q, 4, 0.25).shape == \
            q.shape
        xyzt = torch.empty((5, 4), device="cuda")
        tables = [torch.empty((l, 64, 2), device="cuda") for l in (3, 2)]
        res = [torch.empty((t.shape[0],), device="cuda") for t in tables]
        out = kernels.grid4d_encode_fwd(
            xyzt, [(tables[0], res[0], 64, True, (0, 1, 2), 1),
                   (tables[1], res[1], 64, True, (3,), 2)],
            None, None, torch.bfloat16)
        assert out.shape == (5, 10) and out.dtype == torch.bfloat16
        out = kernels.hash_encode_fwd(xyzt, tables[0], res[0], 64, True)
        assert out.shape == (5, 6) and out.dtype == torch.float32
        x = torch.empty((2, 3, 64), dtype=torch.bfloat16, device="cuda")
        w = torch.empty((2, 64, 32), dtype=torch.int8, device="cuda")
        scale = torch.empty((2, 1, 32), device="cuda")
        out = kernels.int8_bmm(x, w, scale)
        assert out.shape == (2, 3, 32) and out.dtype == torch.bfloat16
        idx, count = kernels.splat_bin(
            torch.empty((5, 2), device="cuda"), torch.empty(5, device="cuda"),
            torch.empty(5, dtype=torch.bool, device="cuda"), 1, 1, 16, 2)
        assert idx.shape == (1, 2) and count.shape == (1,)
        assert idx.dtype == count.dtype == torch.int32
        with pytest.raises(ValueError, match="inference program"):
            kernels.grouped_matmul_split_dout(torch.empty((4, 8),
                                                          device="cuda"))
    assert set(kernels.launch_counts.values()) == {0}
    for name in ("pairwise_attention_fwd", "grid4d_encode_fwd",
                 "hash_encode_fwd", "int8_bmm", "splat_bin"):
        assert hasattr(torch.ops.deepearth, name)


# -- profiling and monitor --------------------------------------------------- #


def test_benchmark_fn_and_step_timer_keys(tmp_path):
    calls = []
    stats = tprofiling.benchmark_fn(lambda: calls.append(1) or torch.ones(3),
                                    iters=5, warmup=2, samples_per_call=4)
    jstats = jprofiling.benchmark_fn(lambda: jnp.ones(3), iters=5, warmup=2,
                                     samples_per_call=4)
    assert stats.keys() == jstats.keys()
    assert len(calls) == 7 and stats["iters"] == 5
    timer, jtimer = tprofiling.StepTimer(), jprofiling.StepTimer()
    assert timer.stats() == jtimer.stats() == {}
    for t in (timer, jtimer):
        for _ in range(3):
            t.start()
            t.stop()
    assert timer.stats().keys() == jtimer.stats().keys()
    assert timer.stats()["steps"] == 3
    with tprofiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    traces = os.listdir(tmp_path / "tr")
    assert len(traces) == 1
    assert "traceEvents" in json.loads((tmp_path / "tr" / traces[0])
                                       .read_text())


def test_resource_snapshot_keys_match_jax():
    got, ref = tmonitor.resource_snapshot(), jmonitor.resource_snapshot()
    assert {k for k in got if k.startswith("sys/")} == {
        k for k in ref if k.startswith("sys/")}
    if not torch.cuda.is_available():
        assert not any(k.startswith("device") for k in got)
    seen = []
    mon = tmonitor.ResourceMonitor(seen.append, interval=0.01).start()
    try:
        for _ in range(200):
            if seen:
                break
            mon._stop.wait(0.01)
    finally:
        mon.stop()
    assert seen and "sys/ram_percent" in seen[0]


def test_modules_import_without_jax_psutil_or_matplotlib():
    """A fresh process in which jax, the JAX package, psutil and matplotlib
    cannot be imported imports the slice's modules; the psutil import comes
    at the first snapshot."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'deepearth_tpu', 'psutil', 'matplotlib'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import deepearth_tpu_torch.utils, deepearth_tpu_torch.export\n"
        "import deepearth_tpu_torch.reconstruction\n"
        "import deepearth_tpu_torch.evaluation.probes\n"
        "import deepearth_tpu_torch.utils.profiling\n"
        "import deepearth_tpu_torch.utils.monitor as m\n"
        "try:\n"
        "    m.resource_snapshot()\n"
        "except ImportError as e:\n"
        "    assert 'psutil' in str(e)\n"
        "else:\n"
        "    raise AssertionError('psutil was not needed')\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'deepearth_tpu', 'psutil', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
