"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536, head_dim=64,
    rwkv=RWKVConfig(head_dim=64, chunk=16, decay_lora=64),
    tie_embeddings=False, supports_long_context=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=256, head_dim=8,
    rwkv=RWKVConfig(head_dim=8, chunk=4, decay_lora=8),
    tie_embeddings=False, supports_long_context=True,
)
