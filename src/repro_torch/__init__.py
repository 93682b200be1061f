"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` SSD simulator.

The JAX package ``repro`` stays the reference; this package grows beside
it slice by slice and imports only ``torch``, numpy and the standard
library.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  See ``repro_torch.api`` for the query surface.
"""
