"""Byte counts of the port's kernels, one module per kernel, named by the
kernel's name in the device trace."""
