"""Batched 2D forward and adjoint solvers of the port."""
