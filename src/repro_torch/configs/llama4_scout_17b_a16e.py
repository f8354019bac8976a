"""Llama4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
MoE 16 experts top-1 (+1 shared), early fusion (text backbone here)."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, n_experts=16, n_shared_experts=1, top_k=1,
    moe_d_ff=8192, rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama4-scout-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, moe_d_ff=128, vocab=256, n_experts=4, capacity_factor=8.0)
