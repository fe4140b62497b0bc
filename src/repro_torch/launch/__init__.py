"""Launch-side tools of the port: the train and serve drivers, the
production mesh and its sharding policy (``mesh``), the dry run on one
card or on a pod or multi-pod mesh (``dryrun``, ``report``), and the wire
and roofline models (``roofline``)."""
