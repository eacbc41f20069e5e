"""One training step of JAMIE's coupled VAE, counted from the model's
shapes (the same whatever implements it). Per modality with input width
`in` (the PCA width the preprocessing returns) and latent width `out`:
the encoder in -> 2 in -> in, the mu and logvar heads in -> out, the
decoder out -> in -> 2 in -> in, each Linear 2 B in_f out_f FLOPs at
batch B; the latent mixing adds corr z and corr^T z, 2 B^2 out each.
Forward plus backward is three times the forward's matmuls."""

from __future__ import annotations

from typing import Sequence


def pca_width(n: int, f: int, pca_dim: int) -> int:
    """The width PCA returns: pca_dim, clamped to the smaller side."""
    return min(int(pca_dim), int(n), int(f))


def forward_flops(in_dims: Sequence[int], out: int, batch: int) -> int:
    total = 0
    for d in in_dims:
        linears = (d * 2 * d + 2 * d * d          # encoder
                   + 2 * d * out                   # mu and logvar heads
                   + out * d + d * 2 * d + 2 * d * d)   # decoder
        total += 2 * batch * linears
    total += 2 * 2 * batch * batch * out           # latent mixing
    return total


def step_flops(in_dims: Sequence[int], out: int, batch: int) -> int:
    return 3 * forward_flops(in_dims, out, batch)
