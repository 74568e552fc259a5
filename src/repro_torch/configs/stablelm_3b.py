"""StableLM-3B — dense MHA (kv == heads).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=256, head_dim=12, tie_embeddings=False,
)
