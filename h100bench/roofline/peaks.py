"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline
share.  A card set below 700 W reads a lower share; the run's card and
power limit are written beside every number kept."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores
