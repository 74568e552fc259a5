"""Model configuration, layers and assembly (uniform-attention family)."""
