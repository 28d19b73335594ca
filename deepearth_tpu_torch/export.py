"""Model export via ``torch.export``, PyTorch port of
``deepearth_tpu/export.py``.

The JAX package serialises a jitted forward as StableHLO; the port's
portable artifact is a ``torch.export`` program saved to bytes, which
reloads and runs without the Python model definition (reference:
tests/run_tests.py:264-329, its TorchScript / ONNX export checks). The
program is keyed to the shapes and dtypes it was traced with: export per
served batch shape.

On the card the program calls every forward kernel through the operators
``kernels`` registers (``torch.ops.deepearth.*``: K1-fwd, K2-fwd's Grid4D
encode and per-table kernel, K3-fwd, K4-fwd, K5-fwd, K6, K7, K8 and
K9-fwd), never their plain versions, so that any forward of the port
exports: the A-stack, the multimodal and flagship models, a quantized
decoder, a splatting render. A program is an inference program, traced
without autograd as JAX's is: the backward kernels are not operators, and
a function that reaches one raises ``ValueError`` while it is traced.
:func:`load_exported` imports ``kernels`` so that a reloaded program finds
the operators.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional

import torch
from torch import nn


class _Fn(nn.Module):
    """A callable as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, *example_args) -> bytes:
    """Serialise ``fn`` (a module or a callable) traced at
    ``example_args`` without autograd (an inference program, as JAX's) to
    bytes. ``fn`` runs once on them first: tables the port caches per shape
    on the host (RoPE's cos / sin) are then made from real tensors and
    enter the program as constants. The bytes hold no copy of the example
    arguments (parameters passed as one stay out, as in JAX's)."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    with torch.no_grad():
        module(*example_args)
        program = torch.export.export(module, tuple(example_args))
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> Callable:
    """Deserialise an exported program; returns a callable running it
    (without autograd, as it was traced)."""
    from . import kernels  # noqa: F401  (registers the deepearth operators)

    module = torch.export.load(io.BytesIO(blob)).module()

    def run(*args):
        with torch.no_grad():
            return module(*args)
    return run


def _outputs(out: Dict):
    return out["fused_representation"], out["reconstructions"]


class _ParamsForward(nn.Module):
    """``fn(params, batch)``: the model's forward with its parameters taken
    from ``params``; the model is not a submodule, so its weights stay out
    of the program."""

    def __init__(self, model: nn.Module):
        super().__init__()
        object.__setattr__(self, "_model", model)

    def forward(self, params, batch):
        return _outputs(torch.func.functional_call(self._model, params,
                                                   (batch,)))


class _BakedForward(nn.Module):
    """``fn(batch)``: the model's forward with the weights ``params`` in the
    program, as parameters of this wrapper; the model itself is not a
    submodule and is left as it was."""

    def __init__(self, model: nn.Module, params: Dict[str, torch.Tensor]):
        super().__init__()
        object.__setattr__(self, "_model", model)
        self._names = list(params)
        self.weights = nn.ParameterList(
            nn.Parameter(t.detach(), requires_grad=False)
            for t in params.values())

    def forward(self, batch):
        params = dict(zip(self._names, self.weights))
        return _outputs(torch.func.functional_call(self._model, params,
                                                   (batch,)))


def _model_params(model: nn.Module,
                  params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` as a dict, raising ``ValueError`` unless its keys are
    exactly the names of ``model.named_parameters()``."""
    params = dict(params)
    names = {name for name, _ in model.named_parameters()}
    unknown = sorted(set(params) - names)
    if unknown:
        raise ValueError(f"not parameters of the model: {unknown}")
    missing = sorted(names - set(params))
    if missing:
        raise ValueError(f"parameters of the model missing: {missing}")
    return params


def _export_eval(model: nn.Module, wrapper: nn.Module, *args) -> bytes:
    """Export ``wrapper`` with ``model`` in eval mode (JAX's
    ``deterministic=True``), its mode restored after."""
    training = model.training
    model.eval()
    try:
        return export_fn(wrapper, *args)
    finally:
        model.train(training)


def export_forward(model: nn.Module, params: Dict[str, torch.Tensor],
                   example_batch) -> bytes:
    """Export a DeepEarthModel forward with its parameters as an argument.

    The returned bytes reload with :func:`load_exported`; call the result
    as ``fn(params, batch)`` with ``params`` keyed as
    ``model.named_parameters()`` and the batch of the same structure and
    shapes. Returns (fused representation, {head: reconstruction}).
    """
    return _export_eval(model, _ParamsForward(model),
                        _model_params(model, params), example_batch)


def export_model_forward(model: nn.Module,
                         params: Optional[Dict[str, torch.Tensor]],
                         example_batch) -> bytes:
    """Like :func:`export_forward` but with the weights BAKED into the
    artifact (``params``, keyed as ``model.named_parameters()``, or None
    for the model's own) -- the deployment shape where the artifact is the
    whole model; call the reloaded fn as ``fn(batch)``. The model is not
    changed, as JAX's closes over ``params``."""
    params = (dict(model.named_parameters()) if params is None
              else _model_params(model, params))
    return _export_eval(model, _BakedForward(model, params), example_batch)
