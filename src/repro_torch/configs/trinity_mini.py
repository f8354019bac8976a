"""Trinity-Mini (arcee-ai, ``model_type`` afmoe, 26B-A3B)
[hf:arcee-ai/Trinity-Mini config.json]: 32 layers, the first 2 dense
SwiGLU at 6,144, then 128 routed experts of width 1,024 (8 a token) and
one shared; sigmoid routing with a selection bias (load_balance_coeff
1e-3), the weights normalised over the chosen (route_norm) times
route_scale 2.826; a 2,048-token window on three layers of four, full
attention without RoPE on every fourth; per-head q/k norms, an output
gate, sandwich norms, embeddings times sqrt(d_model) (mup_enabled);
vocabulary 200,192, untied.

Not one of ``ARCHS`` (the JAX package has no such model); reached as
``get_config("trinity_mini")``."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="trinity-mini", family="moe",
    n_layers=32, d_model=2048, n_heads=32, n_kv=4, d_ff=6144,
    vocab=200192, head_dim=128, n_experts=128, n_shared_experts=1,
    top_k=8, moe_d_ff=1024, rope_theta=10_000.0, norm_eps=1e-5,
    router="sigmoid", route_scale=2.826, bias_rate=1e-3,
    dense_layers=2, window=2048, global_every=4, block="afmoe",
)


def reduced() -> ModelConfig:
    """8 layers (2 dense, kinds W W W F W W W F), 8 experts of which 2 a
    token, a window of 8 (at S = 32), a 64-id vocabulary."""
    return dataclasses.replace(
        CONFIG, name="trinity-mini-smoke", n_layers=8, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=96, moe_d_ff=32, vocab=64,
        n_experts=8, top_k=2, window=8, pad_vocab_multiple=64)
