"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit). A roofline share is stated against these, with the
card's own power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
