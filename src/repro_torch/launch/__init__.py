"""Launch-side models of the port (the mesh wire models)."""
