"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision family].  The vision tower is a STUB:
input_specs provides precomputed patch embeddings (1024 tokens, dim 7680)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    kind="vlm",
    num_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_every=5,
    vision_tokens=1024,
    vision_dim=7680,
    rope_theta=500_000.0,
)
