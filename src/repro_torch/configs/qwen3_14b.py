"""Qwen3-14B — dense GQA with qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

# 40 heads / 8 kv heads don't divide 16: attention replicated over model.
CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=False,
    mesh_rules={"heads": None, "kv_heads": None},
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, qk_norm=True,
    tie_embeddings=False,
)
