"""The training steps' share of the card's peak in the model matmuls'
precision, in %: the coupled VAE's step FLOPs counted from its shapes
(roofline/coupled_vae.py) times the steps, over the Training seconds.
float32 model matmuls (TF32 off) are held to the float32 peak, bfloat16
ones to the dense bf16 peak."""

import records
from roofline import coupled_vae

_PEAK = {'float32': 'fp32_flops', 'bfloat16': 'bf16_flops'}


def read(rec):
    peaks = rec.get('peaks')
    if not peaks:
        return None
    cfg = rec['config']
    kw = cfg['kwargs']
    dims = [coupled_vae.pca_width(n, f, p)
            for (n, f), p in zip(cfg['shapes'], kw['pca_dim'])]
    peak = peaks[_PEAK[kw.get('model_matmul_dtype', 'float32')]]

    def one(f):
        flops = coupled_vae.step_flops(dims, kw['output_dim'], f['batch'])
        steps = f['epochs_run'] * f['steps_per_epoch']
        return 100.0 * flops * steps / f['mapping']['Training'] / peak
    return records.mean_of(rec, one)
