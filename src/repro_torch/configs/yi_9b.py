"""Yi-9B [arXiv:2403.04652; hf]: llama-arch GQA kv=4."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11008,
    vocab=64000, rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=2, d_ff=128, vocab=256)
