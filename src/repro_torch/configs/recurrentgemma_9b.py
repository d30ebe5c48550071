"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention, pattern (rglru, rglru, attn)
[arXiv:2402.19427].  Sub-quadratic (bounded window): runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    kind="hybrid",
    num_layers=38,   # 12 x (rglru, rglru, attn) + 2 trailing rglru
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    pattern=("rglru", "rglru", "attn"),
    window=2048,
    lru_width=4096,
)
