"""Dynamic time warping with traceback for the alignment visualizer: the
port's own copy of `video_rep_learning_tpu/utils/dtw.py` (the same
distance, matrices and path, ties included).

Functional parity with the reference's vendored DTW (`utils/dtw.py:6-61`,
originally pierre-rouanet/dtw): accumulated-cost matrix over a cdist
distance, returning (min distance, cost matrix, accumulated matrix, path).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist


def dtw(x, y, dist="sqeuclidean"):
    """Align sequences x (N, D) and y (M, D). Returns
    (distance, cost_matrix, acc_cost_matrix, (path_x, path_y)).

    Distance is the raw accumulated cost `acc[-1, -1]` (NOT length-normalized)
    and traceback tie-breaking is diagonal-first, matching the reference's
    vendored DTW (`utils/dtw.py:44,47-61`)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    cost = cdist(x, y, dist)
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(n):
        for j in range(m):
            acc[i + 1, j + 1] = cost[i, j] + min(acc[i, j], acc[i, j + 1],
                                                 acc[i + 1, j])
    inner = acc[1:, 1:]
    # degenerate single-row/column paths (`utils/dtw.py:38-42`)
    if n == 1:
        path = (np.zeros(m, dtype=int), np.arange(m))
    elif m == 1:
        path = (np.arange(n), np.zeros(n, dtype=int))
    else:
        path = _traceback(acc)
    return inner[-1, -1], cost, inner, path


def _traceback(acc):
    """Walk the PADDED accumulated matrix from the corner, argmin over
    (diag, up, left) — ties resolve diag > up > left (`utils/dtw.py:47-61`)."""
    i, j = np.array(acc.shape) - 2
    px, py = [i], [j]
    while i > 0 or j > 0:
        tb = int(np.argmin((acc[i, j], acc[i, j + 1], acc[i + 1, j])))
        if tb == 0:
            i -= 1
            j -= 1
        elif tb == 1:
            i -= 1
        else:
            j -= 1
        px.insert(0, i)
        py.insert(0, j)
    return np.array(px), np.array(py)
