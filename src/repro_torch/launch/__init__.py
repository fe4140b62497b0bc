"""Launch-side tools of the port: the train and serve drivers and the mesh
wire models (``roofline``)."""
