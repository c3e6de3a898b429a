"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what a roofline share is taken
against.  A card set below 700 W runs slower; each run's record names its
card."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
