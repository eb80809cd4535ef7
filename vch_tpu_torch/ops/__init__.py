"""Operators, potentials and the CUDA-kernel wrappers of the port."""
