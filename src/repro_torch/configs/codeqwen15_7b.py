"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B; hf]: qwen1.5 arch (QKV bias)."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=13440,
    vocab=92416, qkv_bias=True, rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="codeqwen1.5-7b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256)
