"""xLSTM-125M [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks
(every 4th block sLSTM), d_ff=0 (projection lives inside the block).
Sub-quadratic: runs long_500k with O(1) recurrent state."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304, slstm_every=4, proj_factor=2.0, subquadratic=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", n_layers=3, d_model=64, n_heads=2,
        n_kv=2, vocab=256, slstm_every=3)
