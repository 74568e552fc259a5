"""Gemma3-27B — dense, 5:1 local(sliding-window 1024):global attention,
qk-norm, 262k vocab, 128k context.  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

# Sub-quadratic majority (sliding-window locals) -> long_500k runs; the
# few global layers shard their 500k KV cache over the model axis.
CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    sliding_window=1024, local_global_ratio=5,
    tie_embeddings=True, supports_long_context=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    num_layers=7, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    qk_norm=True, sliding_window=8, local_global_ratio=2,
    tie_embeddings=True, supports_long_context=True,
)
