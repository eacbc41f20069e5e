"""jamie_tpu_torch.figures against jamie_tpu.figures on the CPU: each plot
drawn on the Agg backend by both packages on the same inputs, compared by
the axes' numeric content (scatter offsets, patch and bar geometry, line
data, texts, titles, labels and limits).

Tolerances: drawn numbers within 1e-4 relative / 1e-5 absolute (the PCA
projections and silhouettes are float32 computations summed in other
orders); texts equal. The silhouette is held to sklearn's
`silhouette_samples`, which jamie_tpu calls, within 1e-5. The global numpy
RNG (feature subsampling, the impact plot's background picks) is seeded
identically before each package draws.
"""

import contextlib
import io

import matplotlib
import numpy as np
import pytest

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.collections import Collection  # noqa: E402
from matplotlib.patches import Patch  # noqa: E402

from jamie_tpu import figures as ref  # noqa: E402
from jamie_tpu_torch import figures as port  # noqa: E402

CPU = {'device': 'cpu'}


def _axes_content(fig):
    """Everything numeric or textual a reader sees on each axes."""
    out = []
    for ax in fig.axes:
        items = [ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                 np.asarray(ax.get_xlim()), np.asarray(ax.get_ylim()),
                 [t.get_text() for t in ax.get_xticklabels()],
                 [t.get_text() for t in ax.get_yticklabels()]]
        for art in ax.get_children():
            if isinstance(art, Collection):
                items.append(np.asarray(art.get_offsets(), np.float64))
                items += [np.asarray(p.vertices, np.float64)
                          for p in art.get_paths()[:50]]
            elif isinstance(art, Patch) and art is not ax.patch:
                items.append(np.asarray(art.get_path().transformed(
                    art.get_patch_transform()).vertices, np.float64))
        items += [np.asarray(line.get_xydata(), np.float64)
                  for line in ax.lines]
        items += [(t.get_text(), np.asarray(t.get_position(), np.float64))
                  for t in ax.texts]
        out.append(items)
    return out


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert got == want


def _draw_both(draw, seed=0):
    """draw(module, extra_kwargs) in each package; the two figures'
    content."""
    contents = []
    for mod, extra in ((port, CPU), (ref, {})):
        plt.close('all')
        np.random.seed(seed)
        with contextlib.redirect_stdout(io.StringIO()):
            draw(mod, extra)
        contents.append(_axes_content(plt.gcf()))
    plt.close('all')
    return contents


@pytest.fixture(scope='module')
def case():
    rng = np.random.RandomState(0)
    n = 48
    types = np.array(['T', 'B', 'NK'])[rng.randint(0, 3, n)]
    centers = {'T': 0.0, 'B': 2.0, 'NK': -2.0}
    shift = np.array([centers[t] for t in types])[:, None]
    emb = [(shift + rng.randn(n, 4)).astype(np.float32),
           (shift + rng.randn(n, 4)).astype(np.float32)]
    emb2 = [(e + 0.5 * rng.randn(*e.shape)).astype(np.float32) for e in emb]
    data = [rng.rand(n, 10).astype(np.float32),
            rng.rand(n, 8).astype(np.float32)]
    imputed = [[d + 0.1 * rng.randn(*d.shape) for d in data],
               [d + 0.3 * rng.randn(*d.shape) for d in data]]
    return dict(emb=emb, emb2=emb2, labels=[types, types], data=data,
                imputed=imputed)


def test_silhouette_matches_sklearn(case):
    from sklearn.metrics import silhouette_samples
    for x in case['emb']:
        got = port.silhouette_samples(x, case['labels'][0], device='cpu')
        want = silhouette_samples(x, case['labels'][0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_silhouette_singletons_and_row_blocks(case, monkeypatch):
    from sklearn.metrics import silhouette_samples
    x = case['emb'][0][:12]
    labels = np.array([0, 0, 1, 1, 1, 2, 0, 1, 3, 0, 1, 0])   # 2, 3 alone
    want = silhouette_samples(x, labels)
    assert want[5] == 0 and want[8] == 0
    got = port.silhouette_samples(x, labels, device='cpu')
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    monkeypatch.setattr(port, '_block_rows', lambda n: 5)
    np.testing.assert_allclose(
        port.silhouette_samples(x, labels, device='cpu'), got,
        rtol=0, atol=1e-6)


def test_integration_and_feature_scores_equal(case):
    with contextlib.redirect_stdout(io.StringIO()):
        got, k = port.integration_scores([case['emb'], case['emb2']],
                                         case['labels'], ['A', 'B'], **CPU)
        want, k_r = ref.integration_scores([case['emb'], case['emb2']],
                                           case['labels'], ['A', 'B'])
    assert k == k_r and list(got['Algorithm']) == list(want['Algorithm'])
    np.testing.assert_allclose(got[['LTA', 'FOSCTTM']].to_numpy(),
                               want[['LTA', 'FOSCTTM']].to_numpy(), atol=1e-9)
    pred, true = case['imputed'][0][0], case['data'][0]
    for kind in ('pearson', 'auroc'):
        a = port.imputation_feature_scores(pred, true, kind,
                                           rng=np.random.RandomState(1))
        b = ref.imputation_feature_scores(pred, true, kind,
                                          rng=np.random.RandomState(1))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert port._sign_test_p(7, 10) == ref._sign_test_p(7, 10)


# name -> draw(module, extra): every plot of figures.__all__
PLOTS = {
    'plot_integrated': lambda c: lambda m, e: m.plot_integrated(
        c['emb'], c['labels'], names=['a', 'b'], legend=True, method='pca',
        remove_outliers=True, **e),
    'plot_regular': lambda c: lambda m, e: m.plot_regular(
        c['data'], c['labels'], names=['a', 'b'], method='pca', **e),
    'plot_integrated_hybrid_3d': lambda c: lambda m, e: m.plot_integrated(
        c['emb'], c['labels'], method='pca', n_components=3, **e),
    'plot_accuracy': lambda c: lambda m, e: m.plot_accuracy(
        [c['emb'], c['emb2']], c['labels'], ['A', 'B'], **e),
    'plot_accuracy_table': lambda c: lambda m, e: m.plot_accuracy_table(
        [c['emb'], c['emb2']], c['labels'], ['A', 'B'], **e),
    'plot_accuracy_graph': lambda c: lambda m, e: m.plot_accuracy_graph(
        [c['emb'], c['emb2']], c['labels'], ['A', 'B'], **e),
    'plot_silhouette': lambda c: lambda m, e: m.plot_silhouette(
        [c['emb'], c['emb2']], c['labels'], ['A', 'B'], ['m1', 'm2'], **e),
    'plot_auroc': lambda c: lambda m, e: m.plot_auroc(
        c['imputed'], c['data'], ['m1', 'm2'], names=['A', 'B']),
    'plot_correlation': lambda c: lambda m, e: m.plot_correlation(
        c['imputed'], c['data'], ['m1', 'm2'], names=['A', 'B'],
        plot_type='density'),
    'plot_auroc_correlation': lambda c: lambda m, e: m.plot_auroc_correlation(
        c['imputed'], c['data'], ['m1', 'm2'], names=['A', 'B'], index=1),
    'plot_sample': lambda c: lambda m, e: m.plot_sample(
        c['data'][0], c['imputed'][0][0], 'Imputed', 'm1'),
    'plot_distribution': lambda c: lambda m, e: m.plot_distribution(
        [c['data'][0], c['imputed'][0][0]], c['labels'], feature_limit=2,
        title='t'),
    'plot_distribution_alone': lambda c: lambda m, e: (
        m.plot_distribution_alone([c['data'][0], c['imputed'][0][0]],
                                  c['labels'], feature_limit=3, title='t',
                                  sort_type='mse')),
    'plot_distribution_similarity': lambda c: lambda m, e: (
        m.plot_distribution_similarity([c['data'][0], c['imputed'][0][0]],
                                       c['labels'], title='t',
                                       max_features=6)),
    'plot_impact': lambda c: lambda m, e: m.plot_impact(
        np.linspace(0.2, 0.9, 12), [f'gene{i}' for i in range(12)], 0.5,
        max_features=8),
    'plot_shap_summary': lambda c: lambda m, e: m.plot_shap_summary(
        np.random.RandomState(2).randn(10, 6, 2), c['data'][0][:10, :6],
        max_features=4),
    'plot_shap_waterfall': lambda c: lambda m, e: m.plot_shap_waterfall(
        np.random.RandomState(3).randn(6, 2), [0.2, 0.4], max_features=3),
}


@pytest.mark.parametrize('name', sorted(PLOTS))
def test_plot_matches_reference(case, name):
    got, want = _draw_both(PLOTS[name](case))
    assert got and any(any(isinstance(i, np.ndarray) and i.size for i in ax)
                       for ax in got)
    _assert_same(got, want)


def test_every_reference_plot_is_covered():
    assert port.__all__ == ref.__all__
    drawn = {n for n in PLOTS if n in ref.__all__}
    plots = {n for n in ref.__all__ if n.startswith('plot_')}
    assert drawn == plots


def test_plot_integrated_umap_embeds_the_concatenation_once(case,
                                                            monkeypatch):
    from jamie_tpu_torch.solvers import umap
    calls = []
    real = umap.umap_embed

    def spy(x, *a, **kw):
        calls.append(x.shape)
        return real(x, *a, **kw)

    monkeypatch.setattr(umap, 'umap_embed', spy)
    for separate in (False, True):
        calls.clear()
        plt.close('all')
        port.plot_integrated(case['emb'], case['labels'], method='umap',
                             n_neighbors=10, separate_dim=separate, **CPU)
        pts = [np.asarray(ax.collections[0].get_offsets())
               for ax in plt.gcf().axes]
        assert calls == ([(48, 4), (48, 4)] if separate else [(96, 4)])
        assert len(pts) == 2 and all(np.isfinite(p).all() for p in pts)
    plt.close('all')
