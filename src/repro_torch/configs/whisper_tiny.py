"""Whisper-tiny — encoder-decoder; conv audio frontend stubbed (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    tie_embeddings=True,
    # 6 heads and vocab 51865 don't divide the 16-way model axis; the
    # model is tiny (39 MB embed) so replicate those dims.
    mesh_rules={"heads": None, "kv_heads": None, "vocab": None},
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=256, head_dim=8,
    encoder=EncoderConfig(num_layers=2, num_frames=24),
    tie_embeddings=True,
)
