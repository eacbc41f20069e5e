"""Correspondence solvers (the dense prime-dual F-estimator)."""
