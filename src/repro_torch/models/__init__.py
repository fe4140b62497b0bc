"""Models of the port: ``ToyMLP`` for the mesh wire, and the LM stack
(``config``, ``layers``, ``moe``, ``ssm``, ``rglru``, ``model``)."""
