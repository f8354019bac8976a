"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]: 60 routed experts
top-4 + 4 shared; routed experts padded 60 -> 64 for EP-16 divisibility
(DESIGN.md §4)."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=151936, n_experts=60, pad_experts_to=64, n_shared_experts=4,
    top_k=4, moe_d_ff=1408, qkv_bias=True, rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=4, d_ff=96, moe_d_ff=96, vocab=256, n_experts=8,
        pad_experts_to=8, n_shared_experts=2, top_k=2, capacity_factor=8.0)
