"""Correspondence solvers and the legacy projections: the dense prime-dual
F-estimator and its landmark (low-rank) extension, the Hungarian pairs,
the experimental low-rank correspondence, t-SNE and UMAP."""
