"""Serving-side autoregressive decoding — the Predictor tier of generate().

Counterpart of ``paddle_tpu/inference/generation.py``. The serving
artifact is the model's parameter dict plus its config; the decode engines
are :mod:`paddle_tpu_torch.models.generation` (batch generation over the
dense cache, a streaming session) and
:mod:`paddle_tpu_torch.inference.serving` (the continuous-batching engine
over the paged KV cache — ``predictor.serve``). ``GenerationConfig`` here
IS :class:`paddle_tpu_torch.models.generation.GenerationConfig`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import resolve_device
from ..models.generation import (DecodeSession, GenerationConfig, generate,
                                 seed_key)
from ..models.llama import _tree_map, ensure_quantized

__all__ = ["GenerationConfig", "GenerationPredictor"]


class GenerationPredictor:
    """Batch + streaming + continuous-batching decode over a causal-LM
    parameter dict, on ``device`` (the card unless ``"cpu"`` is asked
    for; the parameters are moved there once).

    ``predictor.generate(ids)`` — the whole batch through :func:`generate`.
    ``predictor.stream(ids)`` — one greedy token list per step, through
    :class:`~paddle_tpu_torch.models.generation.DecodeSession`.
    ``predictor.serve(prompts)`` — continuous batching over the paged KV
    cache (:mod:`paddle_tpu_torch.inference.serving`).

    ``quantize="int8"`` converts the parameters once (weight-only int8):
    every tier then decodes through the int8 matmul.
    """

    def __init__(self, params, model_config, gen_config: GenerationConfig,
                 quantize: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self._params = ensure_quantized(
            _tree_map(lambda t: t.to(self.device), params), quantize)
        self._cfg = model_config
        self._gen = gen_config
        self._quantize = quantize
        self._engine = None

    def generate(self, input_ids, prompt_lens=None,
                 seed: Optional[int] = None) -> np.ndarray:
        """Batch decode; ``seed`` overrides ``gen_config.seed``."""
        g = self._gen
        out = generate(self._params, input_ids, self._cfg,
                       max_new_tokens=g.max_new_tokens,
                       prompt_lens=prompt_lens, temperature=g.temperature,
                       top_k=g.top_k, top_p=g.top_p,
                       eos_token_id=g.eos_token_id,
                       pad_token_id=g.pad_token_id,
                       key=seed_key(seed if seed is not None else g.seed))
        return out.cpu().numpy()

    def stream(self, input_ids, prompt_lens=None):
        """Greedy token-at-a-time generator: yields a ``[B]`` numpy array
        per decode step, stopping at ``max_new_tokens`` (rows past EOS
        emit pad)."""
        ids = np.asarray(input_ids)
        B, S = ids.shape
        g = self._gen
        sess = DecodeSession(self._params, self._cfg,
                             capacity=S + g.max_new_tokens)
        logits = sess.prefill(ids, prompt_lens)
        done = np.zeros((B,), bool)
        for t in range(g.max_new_tokens):
            tok = logits.argmax(dim=-1).cpu().numpy().astype(ids.dtype)
            tok = np.where(done, g.pad_token_id, tok)
            yield tok
            if g.eos_token_id is not None:
                done |= tok == g.eos_token_id
                if done.all():
                    return
            if t < g.max_new_tokens - 1:
                logits = sess.step(tok)

    def serve(self, prompts, max_new_tokens=None, serving_config=None):
        """Continuous-batching decode of a request list (one
        variable-length token array per prompt, EOS included, no pad
        tail). The engine is built lazily and kept, so repeat calls reuse
        its block pool and prefix cache; it is rebuilt only when
        ``serving_config`` changes. Greedy outputs equal the dense tier's."""
        if self._engine is None or serving_config is not None:
            import dataclasses

            from .serving import ServingConfig, ServingEngine
            sc = serving_config or ServingConfig()
            if sc.quantize is None and self._quantize is not None:
                # params are already quantized; keep the engine consistent
                sc = dataclasses.replace(sc, quantize=self._quantize)
            if self._engine is None or sc != self._engine.config:
                self._engine = ServingEngine(self._params, self._cfg, sc,
                                             gen_config=self._gen,
                                             device=self.device)
        return self._engine.run(prompts, max_new_tokens=max_new_tokens)
