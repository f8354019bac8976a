"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified]:
GQA kv=8, no biases, tied embeddings."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528,
    vocab=256000, tie_embeddings=True, rope_theta=8_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="command-r-35b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256)
