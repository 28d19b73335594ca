"""Frozen-backbone feature extraction, the PyTorch port's copy of
``deepearth_tpu/data/extractors.py``.

Re-implements the reference's extractor infrastructure
(reference: encoders/modality_infrastructure.py:91-308,
encoders/vision/vjepa2_extractor.py:51): frozen pretrained backbones
produce numpy arrays that the model consumes as pre-extracted embeddings,
as every reference training run did (backbones are frozen everywhere;
reference: modality_infrastructure.py:133-134,231-233). The backbones are
PyTorch modules in both packages; here they run on the card unless the
caller asks for the CPU.

Extractors are pluggable:
* :class:`VJEPA2Extractor`: HF facebook/vjepa2-* video models -> (4608,
  1408) patch embeddings per image (8 temporal x 24 x 24 spatial).
* :class:`LanguageModelExtractor`: a frozen HF LM, token embeddings and
  masked mean pooling.
* :class:`StubExtractor`: deterministic features for tests and air-gapped
  use.

``transformers`` is imported only where a checkpoint is fetched by name.
"""

from __future__ import annotations

import abc
import hashlib
from typing import Dict, Sequence

import numpy as np
import torch


class BaseModalityExtractor(abc.ABC):
    """ABC (reference: encoders/modality_infrastructure.py:91-102)."""

    @abc.abstractmethod
    def extract_native_embeddings(self, inputs) -> np.ndarray:
        ...

    @abc.abstractmethod
    def get_native_dim(self) -> int:
        ...


class StubExtractor(BaseModalityExtractor):
    """Deterministic pseudo-features keyed by input hash; any (seq, dim)."""

    def __init__(self, dim: int = 64, seq_len: int = 1):
        self.dim = dim
        self.seq_len = seq_len

    def extract_native_embeddings(self, inputs: Sequence) -> np.ndarray:
        out = np.zeros((len(inputs), self.seq_len, self.dim), np.float32)
        for i, item in enumerate(inputs):
            seed = int.from_bytes(
                hashlib.blake2b(str(item).encode(), digest_size=8).digest(),
                "little",
            )
            out[i] = np.random.default_rng(seed).standard_normal(
                (self.seq_len, self.dim)
            )
        return out if self.seq_len > 1 else out[:, 0]

    def get_native_dim(self) -> int:
        return self.dim


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the extractor runs its backbone "
                           "on the card by default; pass device='cpu' to run "
                           "it on the CPU")
    return device


class VJEPA2Extractor(BaseModalityExtractor):
    """Frozen V-JEPA2 vision features
    (reference: encoders/vision/vjepa2_extractor.py:51-96: output
    [4608, 1408] = 8 temporal x 576 spatial patches, fp16 storage).
    Without an injected model, fetches the checkpoint on first use.
    """

    def __init__(
        self,
        model_name: str = "facebook/vjepa2-vitg-fpc64-384",
        device="cuda",
        dtype: str = "float16",
        model=None,
        processor=None,
    ):
        """``model``/``processor``: inject already-constructed instances
        (any torch module with ``.config.hidden_size`` + a video processor
        callable), as tests do with a locally built tiny backbone and
        deployments that load checkpoints themselves. Without them, the
        named checkpoint is fetched from the HF hub. ``device``: the card
        unless the caller names another; without a card the default
        raises."""
        device = _device(device)
        if model is None or processor is None:
            from transformers import AutoModel, AutoVideoProcessor

            processor = processor or AutoVideoProcessor.from_pretrained(
                model_name)
            model = model or AutoModel.from_pretrained(model_name)
        self.processor = processor
        self.model = model.to(device).eval()
        self.device = device
        self.dtype = dtype
        self.native_dim = self.model.config.hidden_size

    def extract_native_embeddings(self, images: Sequence) -> np.ndarray:
        """images: list of PIL images / arrays -> (B, 4608, native_dim)."""
        feats = []
        with torch.no_grad():
            for img in images:
                # single image replicated to the clip length the model expects
                inputs = self.processor(
                    [img] * getattr(self.model.config, "frames_per_clip", 16),
                    return_tensors="pt",
                ).to(self.device)
                out = self.model(**inputs).last_hidden_state  # (1, P, H)
                feats.append(out[0].cpu().numpy().astype(self.dtype))
        return np.stack(feats)

    def get_native_dim(self) -> int:
        return self.native_dim


class LanguageModelExtractor(BaseModalityExtractor):
    """Frozen HF LM features with selectable layers + masked-mean pooling
    (reference: encoders/modality_infrastructure.py:192-308)."""

    def __init__(
        self,
        model_name: str = "deepseek-ai/deepseek-llm-7b-base",
        device="cuda",
        layer: int = -1,
        model=None,
        tokenizer=None,
    ):
        """``model``/``tokenizer``: inject constructed instances (see
        :class:`VJEPA2Extractor`), as tests do with a tiny locally built HF
        model. ``device``: the card unless the caller names another."""
        device = _device(device)
        if model is None or tokenizer is None:
            from transformers import AutoModel, AutoTokenizer

            tokenizer = tokenizer or AutoTokenizer.from_pretrained(model_name)
            model = model or AutoModel.from_pretrained(
                model_name, output_hidden_states=True
            )
        self.tokenizer = tokenizer
        self.model = model.to(device).eval()
        if hasattr(self.model.config, "output_hidden_states"):
            self.model.config.output_hidden_states = True
        self.device = device
        self.layer = layer
        self.native_dim = self.model.config.hidden_size

    def tokenize(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        enc = self.tokenizer(
            list(texts), padding=True, truncation=True, return_tensors="np"
        )
        return {k: np.asarray(v) for k, v in enc.items()}

    def extract_native_embeddings(
        self, texts: Sequence[str], pooled: bool = True
    ) -> np.ndarray:
        with torch.no_grad():
            enc = self.tokenizer(
                list(texts), padding=True, truncation=True, return_tensors="pt"
            ).to(self.device)
            out = self.model(**enc)
            hidden = out.hidden_states[self.layer]  # (B, S, H)
            if not pooled:
                return hidden.cpu().numpy().astype(np.float32)
            mask = enc["attention_mask"][..., None].float()
            pooled_h = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1)
        return pooled_h.cpu().numpy().astype(np.float32)

    def get_native_dim(self) -> int:
        return self.native_dim


def run_parallel_extraction(
    extractor: BaseModalityExtractor,
    items: Sequence,
    n_workers: int = 4,
    chunk_size: int = 8,
) -> np.ndarray:
    """Embarrassingly parallel extraction over worker threads
    (reference: encoders/vision/run_parallel_extraction.sh, shell-level GPU
    sharding; here thread-level, the chunks in order)."""
    from concurrent.futures import ThreadPoolExecutor

    chunks = [items[i: i + chunk_size]
              for i in range(0, len(items), chunk_size)]
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        outs = list(ex.map(extractor.extract_native_embeddings, chunks))
    return np.concatenate(outs, axis=0)
