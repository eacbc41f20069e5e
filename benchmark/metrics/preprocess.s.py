"""Seconds per fit of the mapping phase's preprocessing: PCA of both
modalities (on the bf16 residency past 100M elements) and the
standardization."""

import records


def read(rec):
    return records.mean_of(rec, lambda f: f['mapping'].get('Preprocessing'))
