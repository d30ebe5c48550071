"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Encoder-only (same backbone as wav2vec2) [arXiv:2106.07447].  The conv
waveform frontend is a STUB: input_specs provides precomputed frame
embeddings (dim 512); no decode shapes (encoder-only)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    kind="encoder",
    num_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    input_embed_dim=512,
)
