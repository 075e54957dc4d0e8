"""Columnar layout of training records (counterpart of the reference's
``schema/columnar.py``, cut to what the trainer slice reads).

``records_to_columns`` transposes records into one numpy array per dotted
column; fixed-width repeated groups land as one column per slot
(``parents.3.host.cpu.percent``). The feature extractors and the wire
format both consume that layout. The rotating record sinks come with the
scheduler server slice.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Iterable, Sequence

import numpy as np

from dragonfly2_torch.schema import records as R


def read_csv(path: "str | os.PathLike", cls: type) -> list[Any]:
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.append(R.unflatten(cls, row))
    return out


def records_to_columns(recs: Sequence[Any]) -> dict[str, np.ndarray]:
    """Transpose records into one array per dotted column.

    Numeric columns become float64/int64 arrays; string columns become numpy
    unicode arrays. Repeated groups are already fixed-width after
    ``flatten`` so every column has length N.
    """
    if not recs:
        return {}
    flats = [R.flatten(r) for r in recs]
    cols: dict[str, np.ndarray] = {}
    for key in flats[0]:
        vals = [f[key] for f in flats]
        cols[key] = np.asarray(vals)
    return cols


def num_rows(cols: dict[str, np.ndarray]) -> int:
    if not cols:
        return 0
    return len(next(iter(cols.values())))


def concat_columns(blocks: Iterable[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    blocks = [b for b in blocks if b]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks], axis=0) for k in keys}
