"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free, vocab=65024,
ssm_state=16 — Mamba-1 architecture [arXiv:2410.05355].  Sub-quadratic:
runs the long_500k shape."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    kind="ssm",
    num_layers=64,
    d_model=4096,
    n_heads=1,       # unused by mamba blocks
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)
