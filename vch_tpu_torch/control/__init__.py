"""Cost, prox and targets of the port."""
