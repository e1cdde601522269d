"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share of a peak
is stated against these, with the card's power limit printed beside it."""

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

#: The peak a model's step is held to, by its compute dtype.
FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float32": FP32_FLOP_PER_S}
