"""Language embedding service: /embed, /tokenize, /generate, /health, the
PyTorch port of ``deepearth_tpu/serving/language_server.py``
(reference: encoders/language/server.py:31-50 + client.py:14).

The reference serves DeepSeek-V3 embeddings (7168-d) from a llama.cpp GGUF
build needing 300-400 GB RAM (reference: encoders/language/README.md:18-31).
Here the embedder is pluggable:

* :class:`HFEmbedder` — any HF transformers checkpoint (token embeddings +
  masked-mean pooling, matching LanguageModelExtractor semantics,
  reference: encoders/modality_infrastructure.py:192-308).
* :class:`HashEmbedder` — deterministic hash-based embedding for tests and
  air-gapped environments: stable across processes, unit-norm, any dim.
* :class:`DeepSeekEmbedder` — the port's ``DeepSeekForCausalLM``: embeddings
  from its stack, generation over the compressed MLA cache, optionally over
  an int8 / int4 copy of its weights (the kernels K6 / K7 on the card).

Requests are serialized with a model lock, matching the reference server's
concurrency discipline (reference: encoders/language/server.py:27).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..utils.logging import get_logger

logger = get_logger("LanguageServer")


class HashEmbedder:
    """Deterministic text → unit-norm embedding; same text → same vector."""

    def __init__(self, dim: int = 7168):
        self.dim = dim

    def tokenize(self, text: str) -> List[int]:
        return [
            int.from_bytes(
                hashlib.blake2b(w.encode(), digest_size=4).digest(), "little"
            )
            % 50_000
            for w in text.split()
        ]

    def embed(self, text: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.blake2b(text.encode(), digest_size=8).digest(), "little"
        )
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(self.dim).astype(np.float32)
        return v / (np.linalg.norm(v) + 1e-8)


class HFEmbedder:
    """Frozen HF LM embeddings with masked-mean pooling
    (reference: encoders/modality_infrastructure.py:192-308);
    ``transformers`` is imported when one is made. The model runs on the
    card unless the caller passes ``device="cpu"``."""

    def __init__(self, model_name: str, device: str = "cuda"):
        from transformers import AutoModel, AutoTokenizer

        self._torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModel.from_pretrained(model_name).to(device).eval()
        self.device = device
        self.dim = self.model.config.hidden_size

    def tokenize(self, text: str) -> List[int]:
        return self.tokenizer(text)["input_ids"]

    def embed(self, text: str) -> np.ndarray:
        torch = self._torch
        with torch.no_grad():
            enc = self.tokenizer(
                text, return_tensors="pt", truncation=True, max_length=2048
            ).to(self.device)
            out = self.model(**enc).last_hidden_state  # (1, S, H)
            mask = enc["attention_mask"][..., None].float()
            pooled = (out * mask).sum(1) / mask.sum(1).clamp(min=1)
        return pooled[0].cpu().numpy().astype(np.float32)


@contextlib.contextmanager
def _computing_in(module: nn.Module, dtype: torch.dtype):
    """Inside, every submodule of ``module`` that has a compute dtype
    computes in ``dtype``."""
    mods = [m for m in module.modules() if hasattr(m, "compute_dtype")]
    saved = [m.compute_dtype for m in mods]
    for m in mods:
        m.compute_dtype = dtype
    try:
        yield
    finally:
        for m, cd in zip(mods, saved):
            m.compute_dtype = cd


class DeepSeekEmbedder:
    """Embeddings and generation from the port's ``DeepSeekForCausalLM``
    (the JAX package's ``DeepSeekFlaxEmbedder``).

    Embedding = the masked mean of the stack's final hidden states (the
    reference server's ``embedding=True``), computed in float32 over the
    stored parameters whatever their type, as the JAX package applies
    ``DeepSeekTransformer(cfg)`` at its default compute type. With
    ``quantize_int8`` generation runs over a second, quantized copy
    (``ops.quant.quantize_decoder_params``, ``quant_bits`` 8 or 4) while
    embeddings keep the unquantized model, as in the JAX package: about 1.5x
    the weight memory.
    """

    def __init__(self, model: nn.Module, tokenizer=None,
                 quantize_int8: bool = False, quant_min_dim: int = 256,
                 quant_bits: int = 8):
        self.model = model.eval()
        self.cfg = model.cfg
        self.vocab_size = model.vocab_size
        self.dim = self.cfg.hidden_dim
        self.tokenizer = tokenizer or HashEmbedder(dim=self.cfg.hidden_dim)
        self.gen_model = self.model
        if quantize_int8:
            from ..ops.quant import quantize_decoder_params

            self.gen_model = quantize_decoder_params(
                self.model, min_dim=quant_min_dim, bits=quant_bits)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @classmethod
    def from_checkpoint(cls, path: str, hf_config=None, tokenizer=None,
                        quantize_int8: bool = False, device="cuda"):
        from ..models.hf_convert import load_hf_model

        model, _, _ = load_hf_model(path, hf_config, device=device)
        return cls(model, tokenizer, quantize_int8=quantize_int8)

    def tokenize(self, text: str) -> List[int]:
        if hasattr(self.tokenizer, "tokenize"):
            toks = self.tokenizer.tokenize(text)
            return [t % self.vocab_size for t in toks]
        return [t % self.vocab_size for t in self.tokenizer(text)["input_ids"]]

    # max_new_tokens and the prompt length snap to these finite sets, so a
    # client cannot ask for an unbounded cache; over-long prompts keep their
    # most recent tokens
    GEN_TOKEN_BUCKETS = (16, 32, 64, 128, 256)
    PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048)

    def _max_prompt(self) -> int:
        # reads max_position_embeddings from the block config, which has no
        # such field (it is on cfg.mla): as in the JAX package, this always
        # gives the service cap
        mpe = int(getattr(self.cfg, "max_position_embeddings", 0) or 0)
        limit = mpe - self.GEN_TOKEN_BUCKETS[-1]
        cap = self.PROMPT_BUCKETS[-1]
        if limit > 0:
            return max(self.PROMPT_BUCKETS[0], min(cap, limit))
        return max(1, min(cap, mpe - self.GEN_TOKEN_BUCKETS[0])) if mpe else cap

    def _bucket_prompt(self, ids: List[int]) -> tuple:
        """(padded ids, true length): snap to PROMPT_BUCKETS, truncate to
        the model/service cap keeping the most recent tokens."""
        max_prompt = self._max_prompt()
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        prompt_len = len(ids)
        pad_to = next(
            (b for b in self.PROMPT_BUCKETS
             if b >= prompt_len and b <= max_prompt),
            max_prompt,
        )
        return ids + [0] * (pad_to - prompt_len), prompt_len

    @torch.no_grad()
    def embed(self, text: str) -> np.ndarray:
        ids, prompt_len = self._bucket_prompt(self.tokenize(text) or [0])
        ids_t = torch.tensor([ids], dtype=torch.long, device=self.device)
        mask = torch.arange(len(ids), device=self.device)[None] < prompt_len
        emb = self.model.embed_tokens.weight[ids_t]
        with _computing_in(self.model.model, torch.float32):
            h = self.model.model(emb, key_mask=mask, is_causal=True)
        w = mask[..., None].to(h.dtype)
        out = (h * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        return out[0].float().cpu().numpy()

    def generate(self, text: str, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> List[int]:
        from ..models.generation import generate as _generate

        n_req = max(1, min(int(max_new_tokens), self.GEN_TOKEN_BUCKETS[-1]))
        n_bucket = next(b for b in self.GEN_TOKEN_BUCKETS if b >= n_req)
        temperature = float(min(max(float(temperature), 0.0), 4.0))

        ids, prompt_len = self._bucket_prompt(self.tokenize(text) or [0])
        ids_t = torch.tensor([ids], dtype=torch.long, device=self.device)
        if generator is None:
            # per-request entropy: with temperature > 0, two identical
            # requests must not return the identical sample
            generator = torch.Generator(device=self.device).manual_seed(
                int.from_bytes(os.urandom(4), "little"))
        toks = _generate(
            self.gen_model, ids_t, n_bucket, temperature=temperature,
            generator=generator, max_len=len(ids) + n_bucket,
            prompt_len=prompt_len)
        return toks[0, :n_req].cpu().tolist()


class LanguageEmbeddingService:
    def __init__(self, embedder=None):
        self.embedder = embedder or HashEmbedder()
        self._lock = threading.Lock()  # serialize model access
        self.request_count = 0

    def embed(self, texts: List[str]) -> np.ndarray:
        with self._lock:
            return np.stack([self.embedder.embed(t) for t in texts])

    def tokenize(self, text: str) -> List[int]:
        with self._lock:
            return self.embedder.tokenize(text)

    def generate(self, text: str, max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[int]:
        if not hasattr(self.embedder, "generate"):
            raise ValueError(
                f"{type(self.embedder).__name__} backend cannot generate"
            )
        with self._lock:
            return self.embedder.generate(
                text, max_new_tokens=max_new_tokens, temperature=temperature
            )

    def health(self) -> Dict:
        return {
            "status": "healthy",
            "dim": self.embedder.dim,
            "backend": type(self.embedder).__name__,
            "requests": self.request_count,
        }


def make_handler(service: LanguageEmbeddingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt % args)

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            service.request_count += 1
            if self.path == "/health":
                return self._send(200, service.health())
            return self._send(404, {"error": "unknown route"})

        def do_POST(self):
            service.request_count += 1
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/embed":
                    texts = payload.get("texts") or [payload["text"]]
                    emb = service.embed(texts)
                    return self._send(
                        200, {"embeddings": emb.tolist(), "dim": emb.shape[-1]}
                    )
                if self.path == "/tokenize":
                    return self._send(
                        200, {"tokens": service.tokenize(payload["text"])}
                    )
                if self.path == "/generate":
                    # decode over the compressed cache
                    # (models/generation.py); DeepSeekEmbedder only
                    toks = service.generate(
                        payload["text"],
                        max_new_tokens=int(payload.get("max_new_tokens", 32)),
                        temperature=float(payload.get("temperature", 0.0)),
                    )
                    return self._send(200, {"tokens": toks})
                return self._send(404, {"error": "unknown route"})
            except KeyError as e:
                return self._send(400, {"error": f"missing field {e}"})
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:
                return self._send(500, {"error": str(e)})

    return Handler


class LanguageServer:
    def __init__(self, service=None, host: str = "127.0.0.1", port: int = 0):
        self.service = service or LanguageEmbeddingService()
        self._httpd = ThreadingHTTPServer((host, port), make_handler(self.service))
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LanguageServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class LanguageClient:
    """Client (reference: encoders/language/client.py:14)."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _post(self, path, payload):
        import urllib.request

        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def embed(self, text_or_texts) -> np.ndarray:
        if isinstance(text_or_texts, str):
            out = self._post("/embed", {"text": text_or_texts})
            return np.asarray(out["embeddings"][0], np.float32)
        out = self._post("/embed", {"texts": list(text_or_texts)})
        return np.asarray(out["embeddings"], np.float32)

    def tokenize(self, text: str) -> List[int]:
        return self._post("/tokenize", {"text": text})["tokens"]

    def generate(self, text: str, max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[int]:
        return self._post(
            "/generate",
            {"text": text, "max_new_tokens": max_new_tokens,
             "temperature": temperature},
        )["tokens"]

    def health(self) -> Dict:
        import urllib.request

        with urllib.request.urlopen(
            self.base_url + "/health", timeout=self.timeout
        ) as r:
            return json.loads(r.read())
