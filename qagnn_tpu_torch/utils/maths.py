"""Sparse-matrix helper of the legacy preprocessing path.

Counterpart of qagnn_tpu/utils/maths.py (reference utils/maths.py:5): host
code on scipy, used offline, never on the card.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


def normalize_sparse_adj(A, sparse_type: str = "coo"):
    """Row-normalize a scipy sparse matrix: A[i, :] /= sum(A[i, :]), with a
    zero-degree row divided by 1e-5 as the reference does (reference
    utils/maths.py:13-15). Returns the matrix in `sparse_type` format."""
    in_degree = np.array(A.sum(1)).reshape(-1)
    in_degree[in_degree == 0] = 1e-5
    d_inv = sparse.diags(1.0 / in_degree)
    return getattr(d_inv.dot(A), "to" + sparse_type)()
