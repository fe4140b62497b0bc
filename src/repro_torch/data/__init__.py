"""Synthetic LM corpus and its batch pipeline (port of ``repro/data``)."""
