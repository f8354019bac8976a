"""RecurrentGemma-2B [arXiv:2402.19427; hf]: RG-LRU + local attention 1:2
(pattern rec,rec,attn), MQA kv=1, window 2048, GeGLU d_ff=7680.
Sub-quadratic: runs long_500k (bounded window + recurrent state)."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="griffin",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
    vocab=256000, head_dim=256, window=2048, lru_width=2560,
    block_pattern=("rec", "rec", "attn"), act="gelu", subquadratic=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=3, d_model=64,
        n_heads=2, n_kv=1, d_ff=128, vocab=256, head_dim=32, window=16,
        lru_width=64)
