"""Llama-3.2-Vision-11B — dense decoder with cross-attention image layers
every 5th layer; vision frontend stubbed (input_specs provides precomputed
patch embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5, num_image_tokens=1600,
    tie_embeddings=False,
    mesh_rules={"heads": None, "kv_heads": None},
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    cross_attn_every=5, num_image_tokens=16,
    tie_embeddings=False,
)
