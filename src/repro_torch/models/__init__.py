"""Model stack of the port: layers, rope, attention, RG-LRU, the MoE FFN,
the xLSTM blocks and the composable decoder (``transformer``), plus
``convert`` for carrying the JAX package's parameters and caches across."""
