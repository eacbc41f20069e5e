"""What the real-data example twins share: sklearn's `preprocessing.scale`
and a CSV reader on numpy and the standard library alone (the card's
machine has neither sklearn nor pandas), the data-file checks of the
repo's examples, and the options every twin takes on its command line."""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

# The repository's examples/data directory, where the datasets go, in the
# layout the JAX examples read (UnionCom/scGEM/, scMNC/..., scGLUE/)
DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'examples', 'data')

# The strings pandas.read_csv reads as a missing value by default
NA_STRINGS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))


def scale(x) -> np.ndarray:
    """sklearn's `preprocessing.scale(x, axis=0)` of a dense 2-D array, in
    float64 step for step: NaN-aware mean and standard deviation, a second
    centring pass where the centred mean is not close to 0, near-constant
    columns (std under 10 eps) divided by 1, and a third pass where the
    scaled mean is not close to 0. NaNs stay NaN."""
    x = np.array(x, dtype=np.float64)
    mean = np.nanmean(x, axis=0)
    std = np.nanstd(x, axis=0)
    x -= mean
    mean1 = np.nanmean(x, axis=0)
    if not np.allclose(mean1, 0):
        x -= mean1
    std[std < 10 * np.finfo(std.dtype).eps] = 1.0
    x /= std
    mean2 = np.nanmean(x, axis=0)
    if not np.allclose(mean2, 0):
        x -= mean2
    return x


def scale_f32(x) -> np.ndarray:
    """What every loader of the examples does after reading a modality:
    `scale`, NaN -> 0, float32."""
    x = scale(x)
    x[np.isnan(x)] = 0
    return x.astype(np.float32)


def read_csv(path: str):
    """(header, rows) of a comma-separated file with a header line, every
    cell a string, as `pandas.read_csv(path)` splits it."""
    with open(path, newline='') as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [row for row in reader if row]
    return header, rows


def to_float(cells) -> np.ndarray:
    """The cells' float64 values, pandas' missing-value strings as NaN."""
    return np.array([[np.nan if c.strip() in NA_STRINGS else float(c)
                      for c in row] for row in cells], np.float64)


def require(path: str, what: str, data_dir: str) -> None:
    """The examples' data check: where `path` is missing, say so and exit
    with code 0."""
    if not os.path.exists(path):
        print(f'{what} data not found at', data_dir)
        sys.exit(0)


def fit_kwargs(kwargs: dict, quick: bool, quick_cut: dict,
               cuts: dict) -> dict:
    """The example's JAMIE kwargs: `kwargs`, with `quick_cut` under
    `--quick` and then `cuts` (the epochs a smoke run cuts) over them."""
    out = dict(kwargs)
    if quick:
        out.update(quick_cut)
    out.update(cuts)
    return out


def parser(doc: str, data_dir: str, quick: bool = True,
           fits: bool = True) -> argparse.ArgumentParser:
    """The options every twin adds to its example's: the device and the
    data directory; `--quick` where the example has it, and the epoch cuts
    where it fits JAMIE."""
    ap = argparse.ArgumentParser(description=doc.split('\n\n')[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the host (default: the CUDA card)")
    ap.add_argument('--data-dir', default=data_dir,
                    help=f'the dataset directory (default: {data_dir})')
    if quick:
        ap.add_argument('--quick', action='store_true')
    if not fits:
        return ap
    ap.add_argument('--epoch-dnn', type=int, default=None,
                    help="JAMIE's epoch_DNN, cut (with --min-epochs)")
    ap.add_argument('--min-epochs', type=int, default=None)
    ap.add_argument('--epoch-pd', type=int, default=None)
    return ap


def cuts_of(args) -> dict:
    """The JAMIE kwargs that the parsed epoch options set."""
    return {k: v for k, v in (('epoch_DNN', args.epoch_dnn),
                              ('min_epochs', args.min_epochs),
                              ('epoch_pd', args.epoch_pd)) if v is not None}
