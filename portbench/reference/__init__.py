"""Plain PyTorch references of what the benchmark's cells compute.  They
import nothing of the program."""
