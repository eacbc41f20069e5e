"""Seconds of the estimator's Distance phase per fit: the distance
matrices (K3 or the bf16-resident Gram), with the host kNN graph and
Dijkstra in a geodesic fit."""

import records


def read(rec):
    return records.mean_of(rec, lambda f: f['phases'].get('Distance'))
