"""Label parsing for the reference CSV and labels.txt formats, and the
de-normalization: a numpy copy of ``sqtpu/data/labels.py``, with the CSV
row writer (:func:`csv_row`) that ``generate`` and ``predict`` share.

The 21-value CSV row is ``fn, a1..a3, e1, e2, t1..t3, m11..m33, q1..q4``.
Two normalizations exist in the reference, and both are here: torch
(a/255, e, t/255, q) and keras ((a−25)/50, e, t/255, q), each a
12-vector in the order [a, e, t, q]. A header row (its second column not a
number) is skipped.
"""

from __future__ import annotations

import numpy as np


def _rows(path: str, skip_header: bool) -> list[list[str]]:
    with open(path, "r") as f:
        lines = [ln for ln in f.read().split("\n") if ln]
    if skip_header and lines and not _is_float(lines[0].split(",")[1]):
        lines = lines[1:]
    return [ln.split(",") for ln in lines]


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _labels(cols: list[str], a_lo: float, a_scale: float) -> list[float]:
    vals = [float(v) for v in cols[1:9]]  # a1..a3, e1, e2, t1..t3
    a = [(v - a_lo) / a_scale for v in vals[0:3]]
    t = [v / 255.0 for v in vals[5:8]]
    return a + vals[3:5] + t + [float(v) for v in cols[-4:]]


def csv_row(fn: str, p12: np.ndarray, M: np.ndarray) -> str:
    """One 21-column label row of normalized ``p12`` and its rotation
    matrix ``M``: fn, a·255, e, t·255, M row-major, q, each ``%f`` (the
    writer of ``sqtpu/generate.py::_csv_row``)."""
    vals = np.concatenate([
        p12[0:3] * 255.0, p12[3:5], p12[5:8] * 255.0, M.ravel(), p12[8:12]])
    return (fn + "," + ("%f," * 21) % tuple(vals))[:-1] + "\n"


def parse_csv_torch(path: str, dtype=np.float32) -> np.ndarray:
    """(N, 12) labels with the torch normalization (a/255, e, t/255, q)."""
    return np.asarray([_labels(c, 0.0, 255.0)
                       for c in _rows(path, skip_header=True)], dtype=dtype)


def parse_csv_keras(path: str, dtype=np.float32) -> np.ndarray:
    """(N, 12) labels with the keras normalization ((a−25)/50, e, t/255,
    q)."""
    return np.asarray([_labels(c, 25.0, 50.0)
                       for c in _rows(path, skip_header=True)], dtype=dtype)


def parse_labels_txt(path: str,
                     dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """The example ``labels.txt`` (header, 21 columns, the filename first):
    (filenames, (N, 12) torch-normalized params)."""
    rows = _rows(path, skip_header=True)
    return ([c[0] for c in rows],
            np.asarray([_labels(c, 0.0, 255.0) for c in rows], dtype=dtype))


def denormalize_torch(p: np.ndarray) -> np.ndarray:
    """[a·255, e, t·255, q]: the reference units printed by the reference's
    single-image test script."""
    p = np.asarray(p)
    out = p.copy()
    out[..., 0:3] = p[..., 0:3] * 255.0
    out[..., 5:8] = p[..., 5:8] * 255.0
    return out
