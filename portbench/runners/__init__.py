"""Runners: one module per kind of cell, named by a traffic file's
``runner`` field."""
