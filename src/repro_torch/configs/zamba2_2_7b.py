"""Zamba2-2.7B — hybrid: Mamba2 backbone + one shared attention block
applied every 6 layers.  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=64),
    attn_every=6,
    tie_embeddings=True, supports_long_context=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=32, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=256, head_dim=8,
    ssm=SSMConfig(state_dim=8, head_dim=8, expand=2, conv_kernel=4, chunk=8),
    attn_every=2,
    tie_embeddings=True, supports_long_context=True,
)
