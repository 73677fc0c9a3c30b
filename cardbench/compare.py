"""The comparison that decides ``correct``: served logits against the
plain reference's, row by row.

A row's gap is the largest absolute difference of its logits from the
reference's, over the largest absolute reference logit of that row.  A
logit that is not finite makes its row's gap infinite.
"""

from __future__ import annotations

import numpy as np


def row_gaps(served: np.ndarray, ref: np.ndarray) -> np.ndarray:
    served = np.asarray(served, np.float64)
    ref = np.asarray(ref, np.float64)
    served = np.where(np.isfinite(served), served, np.inf)
    den = np.maximum(np.abs(ref).max(axis=1), np.finfo(np.float64).tiny)
    return np.abs(served - ref).max(axis=1) / den
