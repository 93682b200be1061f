"""Architecture configs of the port: the shape grid, ``Arch`` bundles and
the ``--arch`` registry (only ``recurrentgemma-9b`` is ported so far)."""
