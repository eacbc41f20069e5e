"""The benchmark's data, found by name.

`BENCHMARK.json` at the repository's root lists the configurations, the
cells (`workloads`) and the metrics. Everything that belongs to one of them
is a file of its own under this folder, named after it:

- a configuration's sizes and kwargs: the `file` its entry names
  (`configs/<config>.json`);
- a traffic mix: `traffic/<traffic>.json`;
- a cell's correctness limits: `workloads/<cell>.json`;
- a per-layer metric's reader: `metrics/<metric>.py`, whose
  `read(record)` returns the value or None where it finds nothing;
- a route's harness: `harness/<name>.py`, named by a configuration's
  optional `harness` key (default `dense`). It makes the modalities as a
  user hands them to `fit_transform` (`make_host`), names the
  route-specific part of what a fit produced (`produced`) and the shape
  and state dtype its solve ran at (`solve`), and judges what only that
  route makes (`Reference`; `harness/dense.py` says what each provides).

Adding one of them means adding files and `BENCHMARK.json` entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

NAME_RE = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT_RE = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def load(root: Optional[Path] = None) -> dict:
    """BENCHMARK.json of the checkout at `root` (the repository's)."""
    root = REPO if root is None else Path(root)
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e['name'] == name:
            return e
    raise KeyError(f'no {what} named {name!r} in BENCHMARK.json')


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench['workloads'], name, 'cell')


def config(bench: dict, name: str, root: Optional[Path] = None) -> dict:
    entry = _by_name(bench['configs'], name, 'configuration')
    root = REPO if root is None else Path(root)
    with open(root / entry['file']) as f:
        return json.load(f)


def _json(kind: str, name: str, here: Optional[Path]) -> dict:
    with open((HERE if here is None else Path(here)) / kind
              / f'{name}.json') as f:
        return json.load(f)


def traffic(name: str, here: Optional[Path] = None) -> dict:
    return _json('traffic', name, here)


def limits(cell_name: str, here: Optional[Path] = None) -> dict:
    return _json('workloads', cell_name, here)['limits']


def metrics_for(bench: dict, kind: str, cell_name: str) -> list:
    """The `end_to_end` or `per_layer` entries a cell reports: those with
    no `workloads` key and those that list it."""
    return [m for m in bench[kind]
            if 'workloads' not in m or cell_name in m['workloads']]


def _module(kind: str, name: str, here: Optional[Path]):
    """<kind>/<name>.py under this folder (or `here`), loaded by path."""
    path = (HERE if here is None else Path(here)) / kind / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_{kind}_' + re.sub(r'\W', '_', name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, here: Optional[Path] = None):
    """The `read` function of metrics/<name>.py."""
    return _module('metrics', name, here).read


def harness_name(config: dict) -> str:
    """The harness a configuration names: its `harness` key, or `dense`."""
    return config.get('harness', 'dense')


def harness(config: dict, here: Optional[Path] = None):
    """The module harness/<name>.py of a configuration (`harness_name`)."""
    return _module('harness', harness_name(config), here)


def problems(bench: dict) -> list:
    """What in a BENCHMARK.json breaks the naming rules: names, units,
    references between entries, files that are missing."""
    out = []
    kinds = ('configs', 'workloads', 'end_to_end', 'per_layer')
    seen = set()
    for kind in kinds:
        for e in bench.get(kind, []):
            name = e.get('name', '')
            if not NAME_RE.match(name):
                out.append(f'{kind}: bad name {name!r}')
            if (kind, name) in seen:
                out.append(f'{kind}: {name!r} twice')
            seen.add((kind, name))
            if 'unit' in e and not UNIT_RE.match(e['unit']):
                out.append(f'{name}: bad unit {e["unit"]!r}')
            if kind in ('end_to_end', 'per_layer') and \
                    e.get('better') not in ('lower', 'higher'):
                out.append(f'{name}: better must be lower or higher')
    metric_names = [m['name'] for k in ('end_to_end', 'per_layer')
                    for m in bench.get(k, [])]
    if len(metric_names) != len(set(metric_names)):
        out.append('a metric name is used twice')
    configs = {c['name'] for c in bench.get('configs', [])}
    cells = {w['name'] for w in bench.get('workloads', [])}
    for w in bench.get('workloads', []):
        for key in ('config', 'traffic'):
            if not NAME_RE.match(w.get(key, '')):
                out.append(f'{w["name"]}: bad {key}')
        if w.get('config') not in configs:
            out.append(f'{w["name"]}: unknown config {w.get("config")!r}')
        if not (HERE / 'traffic' / f'{w.get("traffic")}.json').is_file():
            out.append(f'{w["name"]}: no traffic file')
        if not (HERE / 'workloads' / f'{w["name"]}.json').is_file():
            out.append(f'{w["name"]}: no workloads file')
    for c in bench.get('configs', []):
        for key in c.get('reduced', []):
            if not NAME_RE.match(key):
                out.append(f'{c["name"]}: bad reduced key {key!r}')
        if not (REPO / c['file']).is_file():
            out.append(f'{c["name"]}: no file {c["file"]}')
            continue
        with open(REPO / c['file']) as f:
            name = harness_name(json.load(f))
        if not isinstance(name, str) or not NAME_RE.match(name):
            out.append(f'{c["name"]}: bad harness {name!r}')
        elif not (HERE / 'harness' / f'{name}.py').is_file():
            out.append(f'{c["name"]}: no harness file harness/{name}.py')
    for m in bench.get('per_layer', []):
        if not (HERE / 'metrics' / f'{m["name"]}.py').is_file():
            out.append(f'{m["name"]}: no reader')
    for kind in ('end_to_end', 'per_layer'):
        for m in bench.get(kind, []):
            for c in m.get('workloads', []):
                if c not in cells:
                    out.append(f'{m["name"]}: unknown cell {c!r}')
    return out
