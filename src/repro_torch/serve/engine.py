"""Batched greedy-decoding engine over the unified model API.

Port of ``repro.serve.engine``: prefill, then a host-driven decode loop
of one ``decode_step`` per token, fixed-batch request slots.  Eager
PyTorch on the parameters' device.  When the config computes in
bfloat16, the engine casts every weight matrix to bfloat16 once at
construction and keeps the copy beside the float32 parameters
(``Params.hold``): the cast is exact, so the numbers are those of a cast
per matmul, and a decode step reads the bfloat16 copy only.  The greedy
pick is ``torch.argmax``, which takes the first maximal index, as
``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import layers as L
from ..models import registry


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    greedy: bool = True


class Engine:
    def __init__(self, cfg, params: L.Params,
                 serve_cfg: ServeConfig | None = None):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg or ServeConfig()
        self.model = registry.get_model(cfg)
        self.device = params.device
        if L.cdtype(cfg) != torch.float32:
            params.hold(L.cdtype(cfg))

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int,
                 frames: np.ndarray | None = None) -> np.ndarray:
        """prompts: (B, S) int32 -> (B, max_new) greedy continuations."""
        B, S = prompts.shape
        dev = self.device
        cache = self.model.init_cache(self.cfg, B, S + max_new, device=dev)
        kw = {}
        if self.cfg.family == "encdec":
            kw["frames"] = torch.as_tensor(np.asarray(frames), device=dev)
        tokens = torch.as_tensor(np.asarray(prompts), device=dev).long()
        logits, cache = self.model.prefill(self.params, tokens, self.cfg,
                                           cache, **kw)
        logits = logits.reshape(B, -1)
        out = []
        tok = torch.argmax(logits, dim=-1)
        for _ in range(max_new):
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, tok, cache,
                                                   self.cfg)
            tok = torch.argmax(logits, dim=-1)
        if not out:
            return np.zeros((B, 0), np.int32)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
