"""Causal / sliding-window GQA flash attention: CUDA kernel, plain version,
ops."""
