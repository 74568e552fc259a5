"""Snowflake Arctic 480B — 128-expert top-2 MoE with a parallel dense
residual MLP per layer.  [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

# 56 heads / 8 kv: attention replicated over model; experts sharded 128/16
# and FSDP-sharded over data (ZeRO-3 gather in the MoE block) so the 468B
# expert params fit 16 GB/chip.  Optimizer state is 8-bit (train config).
CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  capacity_factor=1.25, dense_residual=True),
    tie_embeddings=False,
    mesh_rules={"heads": None, "kv_heads": None},
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                  dense_residual=True),
    tie_embeddings=False,
)
