"""RG-LRU linear recurrence: CUDA kernel, plain version, ops."""
