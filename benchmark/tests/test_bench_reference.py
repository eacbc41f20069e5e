"""The plain reference against the port, stage by stage and through a
whole run, at a tiny size on the CPU. The reference imports nothing of
the program; the port's functions are called here only to compare."""

import numpy as np
import pytest
import torch

import reference as ref
import run

TIGHT = {'dist': 1e-4, 'f': 1e-2, 'pca': 1e-3, 'embed': 1e-5,
         'loss': 1e-5, 'dtheta': 1e-3, 'nu': 1e-3, 'foscttm': 1.0}


def _data(n=120, f=(200, 30), seed=0):
    g = np.random.RandomState(seed)
    z = g.randn(n, 6).astype(np.float32)
    return [(z @ g.randn(6, k) + 0.3 * g.randn(n, k)).astype(np.float32)
            for k in f]


def test_euclidean_and_geodesic_match_the_port():
    from jamie_tpu_torch.ops.distances import geodesic_distances, \
        pairwise_distance
    for x in _data():
        d = ref.euclidean(ref.gram(x, 'cpu'))
        port = pairwise_distance(x, 'euclidean', device='cpu')
        assert ref.rel_fro(port, d) < 1e-6
        geo, undecided = ref.geodesic(d)
        assert not undecided.any()
        assert ref.rel_fro(torch.as_tensor(geodesic_distances(
            x, device='cpu')), geo) < 1e-6


def test_geodesic_bridges_components():
    x = np.concatenate([np.random.RandomState(1).randn(30, 3),
                        np.random.RandomState(2).randn(30, 3) + 100])
    d = ref.euclidean(ref.gram(x.astype(np.float32), 'cpu'))
    geo, _ = ref.geodesic(d, kmax=10)
    assert torch.isfinite(geo).all()
    from jamie_tpu_torch.ops.distances import geodesic_distances
    port = torch.as_tensor(geodesic_distances(x.astype(np.float32),
                                              kmax=10, device='cpu'))
    assert ref.rel_fro(port, geo) < 1e-5


def test_near_tie_entries_are_left_undecided():
    """Rounding that swaps a row's last kept and first left-out neighbour
    reroutes many paths; those entries, and only those, are undecided."""
    x = _data(n=200, f=(40,), seed=3)[0]
    d = ref.euclidean(ref.gram(x, 'cpu'))
    order = torch.argsort(d, dim=1)
    r = 17
    a, b = order[r, 5], order[r, 6]
    tied = d.clone()
    tied[r, b] = tied[b, r] = tied[r, a] * (1 + 1e-7)
    geo, undecided = ref.geodesic(tied, tie=1e-5)
    assert undecided.any()
    # the other pick of the same tie: different paths, none outside the
    # undecided entries
    other = tied.clone()
    other[r, b] = other[b, r] = tied[r, a] * (1 - 1e-7)
    geo2, _ = ref.geodesic(other, tie=1e-5)
    assert ref.rel_fro(geo2, geo) > 1e-4
    assert ref.rel_fro(geo2, geo, undecided) < 1e-6


def test_prime_dual_matches_the_port_in_float32():
    from jamie_tpu_torch.solvers.prime_dual import prime_dual
    a, b = _data()
    da = ref.euclidean(ref.gram(a, 'cpu'))
    db = ref.euclidean(ref.gram(b, 'cpu'))
    want = ref.prime_dual(da, db, 200, 30, 80)
    got = prime_dual(da, db, dx=200, dy=30, epoch_pd=80, verbose=False,
                     precision='highest', device='cpu')
    assert ref.max_rel(got, want) < 1e-4


def test_pca_subspace_matches_the_port():
    from jamie_tpu_torch.preprocess import PCA
    x = _data(f=(200, 30))[0]
    basis, _ = ref.pca_subspace(ref.gram(x, "cpu"), 6)
    scores = PCA(n_components=16, device='cpu').fit_transform(x)
    assert ref.subspace_sine(basis, torch.as_tensor(scores)[:, :6]) < 1e-4


def test_embed_matches_the_model():
    from jamie_tpu_torch.models.coupled_vae import CoupledVAE
    model = CoupledVAE((12, 7), 4, seed=3)
    for layer in model.modules():   # away from the init's running stats
        if hasattr(layer, 'running_var'):
            layer.running_mean.uniform_(-1, 1)
            layer.running_var.uniform_(0.5, 2)
    model.eval()
    params = {k: v.detach() for k, v in model.state_dict().items()}
    for i, w in enumerate((12, 7)):
        x = torch.randn(20, w)
        with torch.no_grad():
            got = model.embed_one(x, i)
        assert ref.max_rel(got, ref.embed(params, i, x)) < 1e-6


def test_init_model_is_the_models_initialization():
    from jamie_tpu_torch.models.coupled_vae import CoupledVAE
    model = CoupledVAE((12, 7), 4, seed=2 ** 31 + 1)
    params, stats = ref.init_model((12, 7), 4, 2 ** 31 + 1)
    got = model.state_dict()
    assert set(got) == set(params) | set(stats)
    for k, v in {**params, **stats}.items():
        assert torch.equal(got[k], v), k


def test_training_follows_the_port():
    """A whole fit's training on the CPU: the reference, from its own
    initialization on the fit's inputs, gives the fit's epoch losses and
    every moving leaf's change and second moment to rounding; the Linear
    biases that BatchNorm cancels get no gradient."""
    import check
    from jamie_tpu_torch import JAMIE
    x = _data(n=130, f=(60, 20), seed=4)
    kw = dict(output_dim=8, batch_size=32, pca_dim=(16, 16), dropout=0,
              min_epochs=2500, epoch_DNN=6, epoch_pd=10,
              distance_mode='euclidean', manual_seed=2 ** 31 + 11)
    jm = JAMIE(device='cpu', **kw)
    jm.fit_transform(dataset=x)
    T = [t.detach() for t in jm.trainer.data]
    p0, s0 = ref.init_model([t.shape[1] for t in T], 8, kw['manual_seed'])
    r = ref.train(p0, s0, T, torch.as_tensor(jm.match_result[0]),
                  epochs=6, batch=32, lr=1e-3, seed=kw['manual_seed'],
                  min_epochs=2500, weights=(1, 1, 1, 1))
    assert r['epoch_losses'] == pytest.approx(jm.trainer.epoch_losses,
                                              rel=1e-5)
    keep = check.moving_leaves(r['grad1'])
    assert not any(k.endswith('dense.bias') for k in keep)
    # four BatchNorm blocks a modality
    assert len(keep) == len(r['grad1']) - 4 * 2
    got = dict(jm.model.named_parameters())
    moved = {k: got[k].detach() - p0[k] for k in keep}
    assert check.leaf_gap(moved, {k: r['params'][k] - p0[k] for k in keep},
                          keep) < 1e-4


def test_foscttm_counts_strictly_closer():
    a = torch.tensor([[0.0], [1.0], [2.0]])
    assert ref.foscttm(a, a) == 0.0
    # b swaps the matches of the first two rows: each of the 4 directed
    # lookups of rows 0 and 1 finds one sample closer than its match
    b = torch.tensor([[1.0], [0.0], [2.0]])
    assert ref.foscttm(a, b) == pytest.approx(4 / 18)


def test_rounding_controls():
    x = torch.tensor([1.0, 1 + 2 ** -12, 1 + 2 ** -10, 3.3e-3])
    t = ref.round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 and t[2] == 1 + 2 ** -10
    f8 = ref.round_fp8(torch.tensor([448.0, 1.0, 0.3]))
    assert f8[0] == 448.0 and f8[1] == 1.0
    assert abs(float(f8[2]) - 0.3) / 0.3 < 2 ** -3


@pytest.mark.parametrize('cell', ['scglue.euclidean',
                                  'scmnc_visual.geodesic'])
def test_a_whole_run_is_correct_on_the_cpu(cell, bench, tiny_configs):
    config = tiny_configs[bench_config(bench, cell)]
    result = run.run_cell(cell, 2 ** 31 + 5, 0.0, False, device='cpu',
                          bench=bench, config=config, limits=TIGHT)
    assert result['correct'] is True, result['checks']
    assert result['attempted'] == 1 and result['failed'] == 0
    assert list(result['checks']) == list(TIGHT)
    assert list(result)[-1] == 'checks'
    assert set(result['metrics']) == {'fit_s', 'peak_gib', 'setup_s'}
    # the training of the one fit is compared
    assert all(result['checks'][k]['value'] is not None
               for k in ('loss', 'dtheta', 'nu'))


def bench_config(bench, cell):
    import manifest
    return manifest.cell(bench, cell)['config']
