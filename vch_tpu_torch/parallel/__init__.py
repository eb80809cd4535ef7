"""Batched scenario PGD of the port (one device)."""
