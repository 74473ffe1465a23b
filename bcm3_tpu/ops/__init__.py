"""Hand-written GPU kernels for hot compute paths (Pallas, Triton route)."""
