"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Every share of a peak is stated
against these, with the card's power limit recorded beside it."""

BF16_FLOPS = 989e12          # dense bf16/fp16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3


def roofline_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
