"""SeamlessM4T-medium [arXiv:2308.11596; hf]: enc-dec, audio frontend STUB
(input_specs provides frame embeddings). 12+12 layers, d=1024.
Vocab 256206 padded to a multiple of 128 for TP."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, enc_layers=12, dec_layers=12,
    d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
    vocab=256206, frontend="audio", act="gelu",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", n_layers=4, enc_layers=2,
        dec_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256)
