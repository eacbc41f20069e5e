"""Seconds per fit of the host kNN graph of a geodesic fit: the k-growing
`_knn_graph` and `connected_components` rounds of each modality, and the
bridge of components where one runs (the program's
`distances.knn_graph` spans)."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.seconds_of(root, 'distances.knn_graph'))
