"""Seconds per fit of the host all-pairs Dijkstra of a geodesic fit, each
modality's scipy `shortest_path(method='D')` and its fill of unreachable
pairs (the program's `distances.shortest_path` spans)."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.seconds_of(root, 'distances.shortest_path'))
