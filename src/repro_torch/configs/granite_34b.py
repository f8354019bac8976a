"""Granite-34B-Code [arXiv:2405.04324; hf]: deep MQA (kv=1) code model."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-34b-smoke", n_layers=3, d_model=48, n_heads=4,
        n_kv=1, d_ff=96, vocab=256)
