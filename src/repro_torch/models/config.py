"""Architecture configuration dataclass shared by every model family."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | xlstm | griffin
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0           # per-expert hidden width (0 -> d_ff)
    capacity_factor: float = 1.25
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0             # sliding-window size for local attention
    # --- griffin (RG-LRU) ---
    block_pattern: tuple = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- xlstm ---
    slstm_every: int = 0        # every i-th block is sLSTM (0 = none)
    proj_factor: float = 2.0
    # --- frontends (assignment: STUBS providing precomputed embeddings) ---
    frontend: str | None = None   # "vision" | "audio" | None
    n_prefix: int = 0             # prefix embedding count for VLM shapes
    # --- misc ---
    act: str = "silu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    subquadratic: bool = False    # can run long_500k
    # sharding adjustments (documented deviations; see DESIGN.md §4)
    pad_heads_to: int = 0         # pad Q heads for TP divisibility (0 = off)
    pad_experts_to: int = 0
    pad_vocab_multiple: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def experts(self) -> int:
        return self.pad_experts_to or self.n_experts

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def e_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (true config, before padding)."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
            + self.n_heads * hd * d
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * self.e_ff \
                + self.n_shared_experts * 3 * d * self.e_ff + d * self.n_experts
        elif self.family == "xlstm":
            pf = self.proj_factor
            mlp = int(2 * d * pf * d) + 4 * int(pf * d) * hd  # proj + qkv-ish
        else:
            mlp = 3 * d * self.d_ff
        layers = self.n_layers
        if self.family == "encdec":
            layers = self.enc_layers + self.dec_layers
            attn = attn * 1.5  # decoder cross-attention amortized
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(layers * (attn + mlp + 2 * d) + emb + d)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top_k routed)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(
            self, family="dense",
            d_ff=(self.top_k + self.n_shared_experts) * self.e_ff)
        return dense_like.param_count() + self.n_layers * d * self.n_experts
