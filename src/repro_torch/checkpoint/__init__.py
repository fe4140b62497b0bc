"""Checkpoints of the port (``checkpointer.py``)."""
