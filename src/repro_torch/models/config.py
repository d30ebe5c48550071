"""Own copy of ``repro/models/config.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_models.py`` holds the two against
drift.

Model configuration covering the 10 assigned architecture families.

Families: dense (GQA transformer), moe, ssm (Mamba-1), hybrid (RG-LRU +
local attention), encoder (bidirectional, no decode), vlm (decoder with
interleaved cross-attention to stubbed vision embeddings).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0          # number of shared (always-on) experts
    moe_capacity: float = 1.25
    dense_first_layer_ff: int = 0  # deepseek-moe keeps layer 0 dense

    # SSM (Mamba-1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # hybrid (RG-LRU)
    pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    window: int = 2048             # local-attention window
    lru_width: int = 0             # 0 -> d_model

    # VLM
    cross_every: int = 0           # a cross-attn layer every k-th layer
    vision_tokens: int = 0
    vision_dim: int = 0

    # modality-frontend stub (audio): precomputed frame embeddings
    input_embed_dim: int = 0

    # RACE-optimized causal FIR residual mixer over the token stream
    # (repro_torch.models.ssm.race_smooth): 0 = off; R > 0 adds R+1 tap scalars
    # and routes the mixer's forward AND gradient through the RACE
    # detect/eliminate/compile pipeline (train path only — taps start at
    # zero, so prefill/decode parity holds at init)
    race_smooth_radius: int = 0

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        D, H, KV, dh, F, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.d_ff, self.vocab)
        total = V * D  # embed
        if not self.tie_embeddings:
            total += V * D
        if self.race_smooth_radius:
            total += self.race_smooth_radius + 1  # FIR taps
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        mlp = 3 * D * F
        for li in range(self.num_layers):
            lk = self.layer_kind(li)
            total += 2 * D  # norms
            if lk == "attn":
                total += attn + mlp
            elif lk == "moe":
                E, Fm = self.moe_experts, self.d_ff
                if li == 0 and self.dense_first_layer_ff:
                    total += attn + 3 * D * self.dense_first_layer_ff
                else:
                    total += attn + E * 3 * D * Fm + D * E \
                        + self.moe_shared * 3 * D * Fm
            elif lk == "mamba":
                di, N, R = self.d_inner, self.ssm_state, self.dt_rank
                total += D * 2 * di + self.ssm_conv * di + di * (R + 2 * N) \
                    + R * di + di * N + di + di * D
            elif lk == "rglru":
                W = self.lru_width or D
                total += D * 2 * W + self.ssm_conv * W + 2 * W * W + W + W * D + mlp
            elif lk == "cross":
                total += attn + mlp + 2 * self.vision_dim * KV * dh
        return total

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE top-k + shared only)."""
        if self.kind != "moe":
            return self.n_params()
        D, F = self.d_model, self.d_ff
        per_layer_moe = self.moe_experts * 3 * D * F
        active_moe = (self.moe_top_k + self.moe_shared) * 3 * D * F
        return self.n_params() - self.num_layers * per_layer_moe \
            + self.num_layers * active_moe

    def layer_kind(self, li: int) -> str:
        if self.kind in ("dense", "encoder"):
            return "attn"
        if self.kind == "moe":
            return "moe"
        if self.kind == "ssm":
            return "mamba"
        if self.kind == "hybrid":
            return self.pattern[li % len(self.pattern)]
        if self.kind == "vlm":
            return "cross" if (li + 1) % self.cross_every == 0 else "attn"
        raise ValueError(self.kind)

    def supports_decode(self) -> bool:
        return self.kind != "encoder"

    def subquadratic(self) -> bool:
        """True iff a 500k-token decode is O(window/state), not O(context)."""
        return self.kind in ("ssm", "hybrid")

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke-test variant: same family/flavor, tiny dims."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=max(2, len(self.pattern) or 2)
            if self.kind != "vlm" else self.cross_every,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_head=16,
            d_ff=128,
            vocab=128,
        )
        if self.kind == "moe":
            kw.update(moe_experts=min(8, self.moe_experts), d_ff=64,
                      dense_first_layer_ff=64 if self.dense_first_layer_ff else 0)
        if self.kind == "vlm":
            kw.update(vision_tokens=8, vision_dim=48)
        if self.kind == "hybrid":
            kw.update(lru_width=64, window=16)
        if self.input_embed_dim:
            kw.update(input_embed_dim=32)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# shapes assigned to the LM pool (seq_len, global_batch, mode)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment skip rules (DESIGN.md section 5)."""
    if shape.mode == "decode" and not cfg.supports_decode():
        return False, "encoder-only architecture has no autoregressive step"
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, ("pure full-attention architecture: 512k dense-KV decode "
                       "is the quadratic case the assignment excludes")
    return True, ""
