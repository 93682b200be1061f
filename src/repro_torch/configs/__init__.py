"""Architecture configs of the port: the shape grid, ``Arch`` bundles and
the ``--arch`` registry of all ten ids."""
