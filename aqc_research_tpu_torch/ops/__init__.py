"""Engines: the MPS engine, its co-sweep gradient, the one-sided Jacobi SVD."""
