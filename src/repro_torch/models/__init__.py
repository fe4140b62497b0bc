"""Models of the port (``ToyMLP`` for the mesh wire)."""
