"""SmolLM-135M — llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.config import ModelConfig

# 9 heads / 3 kv heads don't divide the 16-way model axis: attention
# projections stay replicated over "model" (MLP/vocab still sharded).
CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64,
    tie_embeddings=True,
    mesh_rules={"heads": None, "kv_heads": None},
    # small vocab + wide DP/SP: batch-preserving xent chunks win (§Perf)
    xent_layout="batched",
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, tie_embeddings=True,
)
