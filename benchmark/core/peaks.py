"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit).  A card set below that limit runs slower under load:
every result keeps the card's name beside its numbers."""

# HBM3, bytes per second.
HBM_BYTES_PER_S = 3.35e12
