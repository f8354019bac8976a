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
    # sigmoid routing (afmoe): dropless, the top_k chosen on score + a
    # selection bias that moves by the load-balancing rule after each
    # train step (rate ``bias_rate``), the weights the chosen scores
    # over their sum times ``route_scale``
    router: str = "softmax"     # softmax (capacity-bounded) | sigmoid
    route_scale: float = 1.0
    bias_rate: float = 0.0
    dense_layers: int = 0       # leading layers with a dense MLP (d_ff)
    # the experts this device holds: ``experts_held`` of them (0 -> all)
    # from ``experts_first`` on; the router still scores every expert
    experts_held: int = 0
    experts_first: int = 0
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0             # sliding-window size for local attention
    global_every: int = 0       # with a window: every n-th layer is full
    # "afmoe": per-head q/k RMSNorm, o * sigmoid(h Wg) before Wo, RoPE
    # on windowed layers alone, norms after attention and the FFN too
    # (sandwich), embeddings times sqrt(d_model)
    block: str = "llama"        # llama | afmoe
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

    @property
    def held(self) -> range:
        """The expert indices this device holds."""
        n = self.experts_held or self.experts
        return range(self.experts_first, self.experts_first + n)

    def layer_window(self, i: int) -> int:
        """Layer ``i``'s attention window (0: full attention)."""
        if self.global_every and i % self.global_every == \
                self.global_every - 1:
            return 0
        return self.window

    @property
    def afmoe(self) -> bool:
        return self.block == "afmoe"

    def layer_rope(self, i: int) -> bool:
        return not (self.afmoe and self.layer_window(i) == 0)

    def layer_is_moe(self, i: int) -> bool:
        return self.family == "moe" and i >= self.dense_layers

    def param_count(self) -> int:
        """Analytic parameter count (true config, before padding)."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
            + self.n_heads * hd * d
        # the output gate, the q/k norms and the sandwich norms
        attn += self.afmoe * (d * self.n_heads * hd + 2 * hd + 2 * d)
        dense = 3 * d * self.d_ff
        if self.family == "moe":
            routed = self.experts_held or self.n_experts
            mlp = routed * 3 * d * self.e_ff \
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
        lead = self.dense_layers * (dense - mlp) if self.family == "moe" \
            else 0
        return int(layers * (attn + mlp + 2 * d) + lead + emb + d)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top_k routed)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(
            self, family="dense", dense_layers=0,
            d_ff=(self.top_k + self.n_shared_experts) * self.e_ff)
        moe_layers = self.n_layers - self.dense_layers
        lead = self.dense_layers * 3 * d * (
            self.d_ff - (self.top_k + self.n_shared_experts) * self.e_ff)
        return dense_like.param_count() + lead + moe_layers * d \
            * self.n_experts
