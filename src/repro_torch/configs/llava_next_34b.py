"""LLaVA-NeXT-34B [hf:llava-hf; unverified]: Yi-34B-ish backbone; vision
frontend is a STUB (input_specs provides patch embeddings). TP shards the
flattened H*hd projection dim (7168 %% 16 == 0), so the 56 heads need no
padding."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    vocab=64000, head_dim=128,
    frontend="vision", n_prefix=576, rope_theta=5_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-next-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=2, d_ff=128, vocab=256, head_dim=16, n_prefix=8)
