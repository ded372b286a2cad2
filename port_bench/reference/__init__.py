"""The plain reference the benchmark holds the program's output to:
PyTorch and NumPy only, nothing of the program."""
