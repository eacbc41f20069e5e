"""The benchmark's data: a seeded modality pair made on the device.

The scheme of the repository's synthetic harness data (a rank-`latent`
Gaussian latent z, each modality z W + noise, drawn column chunk by
column chunk so a 241,757-column arm stays bounded), written in torch and
drawn from one `torch.Generator` on `device`:

- `density` (optional, per arm): binary peaks, thresholded at the
  per-column (1 - density) quantile with numpy's linear interpolation;
- `zscore` (per arm): each column standardized to mean 0 and standard
  deviation 1 (population), a constant column left at 0, as the
  reference notebooks scale their inputs before JAMIE.

Nothing is written to disk. The same seed gives the same arrays on one
device; the arrays are not bit-equal to the host numpy generator's.
"""

from __future__ import annotations

import torch

CHUNK = 16384


def _binarize(block: torch.Tensor, density: float) -> torch.Tensor:
    """1.0 where a value lies above its column's (1 - density) quantile
    (linear interpolation between order statistics, as numpy.quantile)."""
    n = block.shape[0]
    pos = (1.0 - density) * (n - 1)
    lo = int(pos)
    frac = pos - lo
    ordered = torch.sort(block, dim=0).values
    hi = min(lo + 1, n - 1)
    tau = ordered[lo] + frac * (ordered[hi] - ordered[lo])
    return (block > tau[None, :]).to(block.dtype)


def _zscore_(block: torch.Tensor) -> torch.Tensor:
    mu = block.mean(0)
    sd = block.std(0, correction=0)
    return block.sub_(mu).div_(torch.where(sd == 0, torch.ones_like(sd), sd))


def make_pair(config: dict, seed: int, device) -> list:
    """[X0, X1] float32 tensors on `device` at the configuration's shapes,
    from `seed` alone."""
    shapes = config['shapes']
    n = int(shapes[0][0])
    if any(int(s[0]) != n for s in shapes):
        raise ValueError(f'the arms need the same cells: {shapes}')
    latent = int(config['latent'])
    noise = float(config['noise'])
    densities = config.get('density') or [None] * len(shapes)
    zscore = config.get('zscore') or [False] * len(shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((n, latent), generator=gen, device=device)
    out = []
    for (_, f), density, scale in zip(shapes, densities, zscore):
        x = torch.empty((n, int(f)), dtype=torch.float32, device=device)
        for s in range(0, int(f), CHUNK):
            e = min(s + CHUNK, int(f))
            w = torch.randn((latent, e - s), generator=gen, device=device)
            block = z @ w
            block += noise * torch.randn((n, e - s), generator=gen,
                                         device=device)
            if density:
                block = _binarize(block, float(density))
            if scale:
                _zscore_(block)
            x[:, s:e] = block
        out.append(x)
    return out
