"""(max,+) trace-indexed matrix fold: CUDA kernel, plain version, ops."""
