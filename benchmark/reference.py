"""The plain reference of a JAMIE fit's stages, and the numbers that judge
a fit against it.

Plain PyTorch: float32 matmuls with TF32 off, and float64 for the raw
rows' Gram, the PCA eigenproblem and the shortest-path closure. A stage
that the configuration states in bf16 operands takes its operands
rounded to bf16. It imports nothing of the program: it is written from
the published method (JAMIE, Cao et al., Nat Mach Intell 5, 631-642
(2023); UnionCom's prime-dual correspondence; sklearn's PCA) and takes
only the raw modalities the benchmark made.

- `gram`: X X^T of the raw rows, accumulated over column chunks;
- `euclidean`: distances from a Gram (the norms on its diagonal);
- `geodesic`: the kNN graph grown from k = 5 by 5 up to 40 until it is
  connected (components bridged at their closest pair beyond that), its
  all-pairs shortest paths by a min-plus (Floyd-Warshall) closure, and
  the entries a near-tie at a row's k-th neighbour leaves undecided;
- `pca_subspace`: the top-r left singular subspace of the centred rows;
- `prime_dual`: UnionCom's prime-dual iteration for F (Adam on F with a
  nonnegativity projection, slack S, duals Mu and Lambda, the scale a);
- `init_model`, `train`: the coupled VAE's initialization from its seed
  and its training (the four-term loss, global-norm clip, Adam) over the
  epochs of a fit, batches and reparameterization noise drawn from the
  fit's seed as the published model draws them;
- `embed`: the coupled VAE's eval-mode mean head on given parameters;
- `foscttm`: the fraction of samples closer than the true match.

`rounding(kind)` rounds a product's operands: 'bf16' to bfloat16, the
precision a configuration states for a stage that runs on bf16 operands
with a float32 result; 'tf32' to TF32 (10 mantissa bits) and 'fp8' to
float8 e4m3 with one scale per tensor (amax to 448), the precisions a
control computes in, one below float32 and bfloat16; in `train` the
rounding is applied to the operands of every product, forward and
backward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]

# Column chunk of a host matrix uploaded at a time (float32 bytes)
_CHUNK_BYTES = 1 << 30


def plain_matmuls() -> None:
    """float32 matmuls in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 (ties away from zero in
    the 13 dropped bits, as the tensor cores' conversion)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, amax: Optional[float] = None) -> torch.Tensor:
    """float32 values through float8 e4m3 with one scale per tensor (its
    largest magnitude mapped to 448), back in float32."""
    x = x.float()
    top = float(x.abs().max()) if amax is None else float(amax)
    if top == 0:
        return x.clone()
    scale = 448.0 / top
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    return x.float().to(torch.bfloat16).float()


def rounding(kind: Optional[str]) -> Round:
    return {None: None, 'bf16': round_bf16, 'tf32': round_tf32,
            'fp8': round_fp8}[kind]


def _r(x: torch.Tensor, rnd: Round) -> torch.Tensor:
    return x if rnd is None else rnd(x)


def mm(a: torch.Tensor, b: torch.Tensor, rnd: Round = None) -> torch.Tensor:
    return _r(a, rnd) @ _r(b, rnd)


# ------------------------------------------------------------- distances
def gram(x: np.ndarray, device, rnd: Round = None) -> torch.Tensor:
    """X X^T (n, n) in float64 over column chunks of the host matrix; with
    `rnd`, of the values rounded in float32 (fp8's scale is the whole
    matrix's)."""
    n, f = x.shape
    amax = None
    if rnd is round_fp8:
        amax = float(np.abs(x).max())
    cols = max(_CHUNK_BYTES // (4 * n), 1)
    g = torch.zeros((n, n), dtype=torch.float64, device=device)
    for s in range(0, f, cols):
        blk = torch.as_tensor(np.ascontiguousarray(x[:, s:s + cols]),
                              device=device)
        if rnd is round_fp8:
            blk = round_fp8(blk, amax)
        elif rnd is not None:
            blk = rnd(blk)
        blk = blk.double()
        g.addmm_(blk, blk.T)
    return g


def euclidean(g: torch.Tensor) -> torch.Tensor:
    """float32 euclidean distances from a Gram: clamp at 0, sqrt, zero
    diagonal."""
    sq = torch.diagonal(g)
    d2 = sq[:, None] + sq[None, :] - 2.0 * g
    d = d2.clamp_(min=0.0).sqrt_()
    d.fill_diagonal_(0.0)
    return d.float()


def _knn_graph(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Symmetric kNN graph (0 = no edge) of each row's neighbours `idx`
    (itself included): the larger of the two directions."""
    g = torch.zeros_like(d)
    g.scatter_(1, idx, torch.gather(d, 1, idx))
    g.fill_diagonal_(0.0)
    return torch.maximum(g, g.T)


def _components(adj: torch.Tensor) -> torch.Tensor:
    """Each vertex's component label: the smallest vertex index it
    reaches (min-label propagation over the edges adj > 0)."""
    n = adj.shape[0]
    edge = adj > 0
    big = torch.full((n, n), n, dtype=torch.int64, device=adj.device)
    label = torch.arange(n, device=adj.device)
    while True:
        nxt = torch.minimum(label, torch.where(edge, label[None, :],
                                               big).min(1).values)
        if torch.equal(nxt, label):
            return label
        label = nxt


def _bridge(adj: torch.Tensor, d: torch.Tensor, label: torch.Tensor):
    """Chain the components in the order of their smallest vertex, each
    consecutive pair joined at its cheapest cross entry of d."""
    roots = torch.unique(label)
    groups = [torch.nonzero(label == r).flatten() for r in roots]
    for a, b in zip(groups[:-1], groups[1:]):
        block = d[a][:, b]
        flat = int(torch.argmin(block))
        i, j = a[flat // len(b)], b[flat % len(b)]
        adj[i, j] = adj[j, i] = block.flatten()[flat]
    return adj


def _closure(adj: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths of a weighted graph (0 = no edge) by the
    min-plus closure in float64; unreachable pairs take the largest
    finite distance."""
    w = adj.double()
    w = torch.where(w > 0, w, torch.full_like(w, math.inf))
    w.fill_diagonal_(0.0)
    for k in range(w.shape[0]):
        torch.minimum(w, w[:, k:k + 1] + w[k:k + 1, :], out=w)
    finite = w[torch.isfinite(w)].max()
    return torch.where(torch.isfinite(w), w, finite)


def geodesic(d: torch.Tensor, kmin: int = 5, kmax: int = 40,
             kstep: int = 5, tie: float = 0.0):
    """kNN-graph shortest-path distances from a euclidean matrix (float32
    result) and the entries they leave undecided: those that change when
    a row whose last kept and first left-out neighbours lie within `tie`
    of each other (relative) keeps the other one instead. Rounding at
    that level can pick either, and the pick moves thousands of paths."""
    n = d.shape[0]
    order = torch.argsort(d, dim=1)
    bridged = False
    for k in range(kmin, max(kmax, kmin) + 1, kstep):
        k = min(k, n - 1)
        idx = order[:, :k + 1]
        adj = _knn_graph(d, idx)
        label = _components(adj)
        if bool((label == 0).all()):
            break
    else:
        adj = _bridge(adj, d, label)
        bridged = True
    g = _closure(adj)
    undecided = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    if tie > 0 and not bridged and k + 1 < n:
        near = torch.gather(d, 1, order[:, k:k + 2]).double()
        gap = (near[:, 1] - near[:, 0]) / near[:, 0].clamp(min=1e-30)
        for r in torch.nonzero(gap < tie).flatten().tolist():
            other = idx.clone()
            other[r, k] = order[r, k + 1]
            moved = (_closure(_knn_graph(d, other)) - g).abs()
            undecided |= moved > 1e-9 * g.max()
    return g.float(), undecided


# ------------------------------------------------------------------ PCA
def pca_subspace(g: torch.Tensor, r: int, iters: int = 16):
    """Orthonormal (n, r) basis of the top-r left singular subspace of the
    centred rows, from their raw Gram: subspace iteration on the centred
    Gram in float64 with 2r vectors, then Rayleigh-Ritz. Returns the basis
    and the Ritz values, largest first."""
    gc = g.double()
    gc = gc - gc.mean(0, keepdim=True) - gc.mean(1, keepdim=True) + gc.mean()
    n = gc.shape[0]
    k = min(2 * r, n)
    gen = torch.Generator(device=gc.device).manual_seed(0)
    q = torch.randn((n, k), generator=gen, device=gc.device,
                    dtype=torch.float64)
    q, _ = torch.linalg.qr(q)
    for _ in range(iters):
        q, _ = torch.linalg.qr(gc @ q)
    w, v = torch.linalg.eigh(q.T @ gc @ q)
    order = torch.argsort(w, descending=True)
    return q @ v[:, order[:r]], w[order]


def subspace_sine(basis: torch.Tensor, cols: torch.Tensor) -> float:
    """Sine of the largest principal angle between the span of `cols` and
    the orthonormal `basis`."""
    q, _ = torch.linalg.qr(cols.double())
    rest = q - basis @ (basis.T @ q)
    return float(torch.linalg.matrix_norm(rest, ord=2))


# ------------------------------------------------------- correspondence
def prime_dual(dx: torch.Tensor, dy: torch.Tensor, fx: int, fy: int,
               iters: int, rho: float = 10.0, epsilon: float = 1e-3,
               delay: int = 0, rnd: Round = None) -> torch.Tensor:
    """UnionCom's prime-dual estimate of the (m, n) correspondence F from
    the two distance matrices; fx, fy: the raw feature widths (the first
    scale a = sqrt(fy / fx)). `rnd` rounds the four GEMMs' operands."""
    m, n = dx.shape[0], dy.shape[0]
    big = max(m, n)
    kx, ky = dx.float() / big, dy.float() / big
    tr = torch.sum(kx * kx.T)
    dev = kx.device
    F = torch.zeros((m, n), device=dev)
    m1 = torch.zeros_like(F)
    m2 = torch.zeros_like(F)
    S = torch.zeros((n, 1), device=dev)
    mu = torch.zeros((m, 1), device=dev)
    lam = torch.zeros((n, 1), device=dev)
    a = torch.tensor(math.sqrt(fy / fx), device=dev)
    fky = torch.zeros_like(F)
    kxfky = torch.zeros_like(F)
    for i in range(1, iters + 1):
        inner = mm(F.T, fky, rnd)
        mm4 = mm(fky, inner, rnd)
        rowsum = F.sum(1, keepdim=True)
        colsum = F.sum(0, keepdim=True)
        grad = (4.0 * mm4 - 4.0 * a * kxfky + (mu + rho * rowsum)
                + (lam.T + rho * (colsum + S.T - 2.0)))
        m1 = 0.9 * m1 + 0.1 * grad
        m2 = 0.999 * m2 + 0.001 * grad * grad
        b1 = 1.0 - 0.9 ** i
        b2 = 1.0 - 0.999 ** i
        step = (m1 / b1) / (torch.sqrt(m2 / b2) + 1e-7)
        F = (1.0 - epsilon) * F + epsilon * torch.clamp(F - step, min=0.0)
        col = F.sum(0, keepdim=True).T
        grad_s = lam + rho * (col - 1.0 + S)
        S = (1.0 - epsilon) * S + epsilon * torch.clamp(S - grad_s, min=0.0)
        mu = mu + epsilon * (F.sum(1, keepdim=True) - 1.0)
        lam = lam + epsilon * (col - 1.0 + S)
        fky = mm(F, ky, rnd)
        kxfky = mm(kx, fky, rnd)
        if i >= delay:
            a = torch.sum(kxfky * F) / tr
    return F


# ---------------------------------------------------------------- model
def embed(params: dict, i: int, x: torch.Tensor, rnd: Round = None,
          eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """Modality i's eval-mode mean head: two blocks of Linear, BatchNorm
    on its running statistics and LeakyReLU(0.01), then the mu Linear.
    `params` maps the coupled VAE's parameter names to tensors."""
    def p(name):
        return params[f'layers.{name}'].to(x.device).float()

    h = x.float()
    for b in (f'enc{i}_b0', f'enc{i}_b1'):
        h = mm(h, p(f'{b}.dense.weight').T, rnd) + p(f'{b}.dense.bias')
        h = ((h - p(f'{b}.bn.running_mean'))
             * torch.rsqrt(p(f'{b}.bn.running_var') + eps)
             * p(f'{b}.bn.weight') + p(f'{b}.bn.bias'))
        h = torch.where(h >= 0, h, slope * h)
    return mm(h, p(f'fc_mu{i}.weight').T, rnd) + p(f'fc_mu{i}.bias')


def _layers(d: int, out: int):
    """(name, in, out, with BatchNorm) of one modality's layers, in the
    model's order: encoder d -> 2d -> d, the mu and logvar heads, decoder
    out -> d -> 2d -> d."""
    return [('enc{}_b0', d, 2 * d, True), ('enc{}_b1', 2 * d, d, True),
            ('fc_mu{}', d, out, False), ('fc_var{}', d, out, False),
            ('dec{}_b0', out, d, True), ('dec{}_b1', d, 2 * d, True),
            ('dec{}_out', 2 * d, d, False)]


def init_model(widths: Sequence[int], out: int, seed: int):
    """The coupled VAE's initial parameters and BatchNorm statistics, by
    name: each Linear's weight (out, in) then bias from U(-1/sqrt(in),
    1/sqrt(in)) (torch.nn.Linear's default), drawn in layer order from one
    CPU generator seeded `seed`; BatchNorm scale 1, bias 0, running mean
    0, variance 1; the mixing weights sigma from U[0, 1) last."""
    gen = torch.Generator().manual_seed(int(seed))
    params, stats = {}, {}
    for i, d in enumerate(widths):
        for tmpl, fin, fout, bn in _layers(int(d), int(out)):
            name = 'layers.' + tmpl.format(i)
            dense = f'{name}.dense' if bn else name
            bound = 1.0 / math.sqrt(fin)
            params[f'{dense}.weight'] = torch.empty(fout, fin).uniform_(
                -bound, bound, generator=gen)
            params[f'{dense}.bias'] = torch.empty(fout).uniform_(
                -bound, bound, generator=gen)
            if bn:
                params[f'{name}.bn.weight'] = torch.ones(fout)
                params[f'{name}.bn.bias'] = torch.zeros(fout)
                stats[f'{name}.bn.running_mean'] = torch.zeros(fout)
                stats[f'{name}.bn.running_var'] = torch.ones(fout)
    params['sigma'] = torch.rand(len(widths), generator=gen)
    return params, stats


class _RoundedMM(torch.autograd.Function):
    """a @ b with every product's operands rounded, forward and backward."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd(g)
        return rg @ rb.T, ra.T @ rg, None


def _tmm(a, b, rnd: Round):
    return a @ b if rnd is None else _RoundedMM.apply(a, b, rnd)


def _row_normalize(m: torch.Tensor) -> torch.Tensor:
    s = m.sum(1)
    return m / torch.where(s == 0, torch.ones_like(s), s)[:, None]


def _batch_loss(p, stats, xs, corr, fn, noise, anneal, weights, rnd,
                eps: float = 1e-5, slope: float = 0.01, momentum: float = 0.9):
    """The coupled VAE's weighted four-term loss on one batch, in train
    mode (BatchNorm on the batch's biased statistics, its running ones
    updated): KL (x 32e-3 x anneal), reconstruction MSE, the latent
    consistency 32 x |z_i - combined_i|^2 / out, and |combined_0 -
    Fn combined_1|^2."""
    def dense(name, h):
        return _tmm(h, p[f'{name}.weight'].T, rnd) + p[f'{name}.bias']

    def block(name, h):
        h = dense(f'{name}.dense', h)
        mean = h.mean(0)
        var = torch.clamp((h * h).mean(0) - mean * mean, min=0.0)
        with torch.no_grad():
            rm, rv = (stats[f'{name}.bn.running_{k}'] for k in ('mean', 'var'))
            rm.mul_(momentum).add_((1 - momentum) * mean)
            rv.mul_(momentum).add_((1 - momentum) * var)
        h = ((h - mean) * (torch.rsqrt(var + eps) * p[f'{name}.bn.weight'])
             + p[f'{name}.bn.bias'])
        return torch.where(h >= 0, h, slope * h)

    zs, mus, logvars = [], [], []
    for i, x in enumerate(xs):
        h = block(f'layers.enc{i}_b1', block(f'layers.enc{i}_b0', x))
        mu = dense(f'layers.fc_mu{i}', h)
        logvar = dense(f'layers.fc_var{i}', h)
        zs.append(mu + (torch.exp(logvar / 2) + 1e-7) * noise[i])
        mus.append(mu)
        logvars.append(logvar)
    s0, s1 = p['sigma'][0], p['sigma'][1]
    comb = [(s0 * zs[0] + s1 * _tmm(corr, zs[1], rnd))
            / (s0 + s1 * corr.sum(1)[:, None]),
            (s1 * zs[1] + s0 * _tmm(corr.T, zs[0], rnd))
            / (s1 + s0 * corr.sum(0)[:, None])]
    kl = rec = 0.0
    for i, x in enumerate(xs):
        h = block(f'layers.dec{i}_b1', block(f'layers.dec{i}_b0', comb[i]))
        x_hat = dense(f'layers.dec{i}_out', h)
        kl = kl + torch.mean(-0.5 * torch.mean(
            1 + logvars[i] - mus[i] ** 2 - torch.exp(logvars[i]), 1))
        rec = rec + torch.mean(torch.mean((x_hat - x) ** 2, 1))
    out = zs[0].shape[1]
    cos = 32.0 * sum(torch.mean(torch.sum((z - c) ** 2, 1)) / out
                     for z, c in zip(zs, comb))
    diff = comb[0] - _tmm(fn, comb[1], rnd)
    fl = torch.mean(torch.mean(diff * diff, 1))
    terms = torch.stack([32e-3 * anneal * kl, rec, cos, fl]) * weights
    return terms.sum()


def train(params: dict, stats: dict, data: Sequence[torch.Tensor],
          F: torch.Tensor, *, epochs: int, batch: int, lr: float, seed: int,
          min_epochs: int, weights: Sequence[float], pf_ratio: float = 1.0,
          rnd: Round = None, b1: float = 0.9, b2: float = 0.999,
          adam_eps: float = 1e-8, max_norm: float = 1.0) -> dict:
    """The coupled VAE trained from `params`, `stats` on the two modalities'
    training rows `data` and the correspondence F, as a fit trains it with
    the identity prior P (equal rows; 'diag' sampling): every epoch one
    permutation of the rows, cut into max(rows) // batch batches; per
    batch the reparameterization noise of modality 0, then 1; the loss's
    gradient clipped to global norm `max_norm`, then Adam (bias
    corrections 1 - b^t in float32). Draws come from a generator on the
    data's device seeded `seed`: the published model's draws, in its
    order. `rnd` rounds every product's operands (the control).

    Returns the final parameters and statistics, Adam's second moment by
    leaf (`nu`), each epoch's mean batch loss, and the first clipped
    gradient by leaf (`grad1`)."""
    dev = data[0].device
    n = int(data[0].shape[0])
    if int(data[1].shape[0]) != n:
        raise ValueError('the reference trains equal rows only')
    steps = max(n // batch, 1)
    if batch > n:
        raise ValueError('the reference draws permutations: batch <= rows')
    names = list(params)
    shapes = [params[k].shape for k in names]
    sizes = [params[k].numel() for k in names]
    flat = torch.cat([params[k].reshape(-1) for k in names]).to(dev)
    flat.requires_grad_(True)
    stats = {k: v.to(dev).clone() for k, v in stats.items()}
    m1 = torch.zeros_like(flat.detach())
    m2 = torch.zeros_like(m1)
    w = torch.tensor([float(x) for x in weights], device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = int(params['layers.fc_mu0.weight'].shape[0])
    c = min_epochs / 2 if min_epochs > 0 else epochs / 2
    losses, grad1, t = [], None, 0
    for e in range(epochs):
        perm = torch.randperm(n, generator=gen, device=dev)
        idx = perm[torch.arange(steps * batch, device=dev) % n].reshape(
            steps, batch)
        ef = torch.tensor(float(e), device=dev)
        anneal = 1.0 / (1.0 + torch.exp(-5.0 * (ef - c) / c))
        total = torch.zeros((), device=dev)
        for s in range(steps):
            rows = idx[s]
            xs = [d[rows] for d in data]
            fn = _row_normalize(F[rows][:, rows])
            corr = pf_ratio * _row_normalize(
                (rows[:, None] == rows[None, :]).float()) \
                + (1 - pf_ratio) * fn
            noise = [torch.randn((batch, out), generator=gen, device=dev)
                     for _ in xs]
            p = {k: v.view(sh) for k, v, sh in
                 zip(names, torch.split(flat, sizes), shapes)}
            loss = _batch_loss(p, stats, xs, corr, fn, noise, anneal, w, rnd)
            g, = torch.autograd.grad(loss, flat)
            with torch.no_grad():
                norm = torch.linalg.vector_norm(g)
                g = torch.where(norm < max_norm, g, g / norm * max_norm)
                if grad1 is None:
                    grad1 = g.clone()
                t += 1
                m1.mul_(b1).add_(g, alpha=1 - b1)
                m2.mul_(b2).addcmul_(g, g, value=1 - b2)
                tt = torch.tensor(float(t), device=dev)
                c1 = 1 - torch.pow(b1, tt)
                c2 = 1 - torch.pow(b2, tt)
                flat.sub_(lr * ((m1 / c1) / (torch.sqrt(m2 / c2) + adam_eps)))
                total += loss.detach()
        losses.append(float(total / steps))

    def leaves(v):
        return {k: x.view(sh) for k, x, sh in
                zip(names, torch.split(v.detach(), sizes), shapes)}
    return {'params': leaves(flat), 'stats': stats, 'nu': leaves(m2),
            'epoch_losses': losses, 'grad1': leaves(grad1)}


def foscttm(e0: torch.Tensor, e1: torch.Tensor, block: int = 2048) -> float:
    """FOSCTTM, both directions: the share of the other modality's samples
    strictly closer to a sample than its true match, over 2 n^2."""
    a, b = e0.double(), e1.double()
    n = a.shape[0]
    diag = ((a - b) ** 2).sum(1)
    closer = 0
    for s in range(0, n, block):
        e = min(s + block, n)
        dab = _sq_cross(a[s:e], b)
        dba = _sq_cross(b[s:e], a)
        closer += int((dab < diag[s:e, None]).sum())
        closer += int((dba < diag[s:e, None]).sum())
    return closer / (2.0 * n * n)


def _sq_cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
            - 2.0 * (x @ y.T))


# -------------------------------------------------------------- numbers
def rel_fro(got: torch.Tensor, want: torch.Tensor, skip=None) -> float:
    """||got - want||_F / ||want||_F, over the entries `skip` leaves."""
    got, want = got.to(want.device).double(), want.double()
    if skip is not None:
        got, want = got[~skip], want[~skip]
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.to(want.device).float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def worst(values: Sequence[float]) -> float:
    return max(values) if values else math.nan
