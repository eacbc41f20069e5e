"""Correspondence solvers: the dense prime-dual F-estimator and its
landmark (low-rank) extension."""
