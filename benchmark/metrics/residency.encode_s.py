"""Host seconds per fit that the residency spends reading and casting the
raw matrices to bf16 before their upload (`transfer_stats` read_s +
encode_s); None where nothing was uploaded through it."""

import records


def read(rec):
    def one(f):
        t = f['transfer']
        if not t.get('bytes'):
            return None
        return t['read_s'] + t['encode_s']
    return records.mean_of(rec, one)
