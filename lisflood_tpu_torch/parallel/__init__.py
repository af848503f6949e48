"""Domain decomposition of the drainage graph (host-side NumPy)."""
