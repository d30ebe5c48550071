"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16, MHA) d_ff=1408
vocab=102400; 2 shared + 64 routed experts top-6, fine-grained
[arXiv:2401.06066].  Layer 0 keeps a dense FFN (d_ff=10944) per the paper."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    kind="moe",
    num_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    moe_experts=64,
    moe_top_k=6,
    moe_shared=2,
    dense_first_layer_ff=10944,
)
