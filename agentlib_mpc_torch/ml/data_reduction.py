"""GPR training-data reduction via Nystroem inducing points.

Port of ``agentlib_mpc_tpu/ml/data_reduction.py``, a copy. Counterpart of
the reference's ``NystroemReducer``
(``modules/ml_model_training/data_reduction.py:33-52``): exact GPR
prediction costs O(n) per query in the training-set size, which lands in
every evaluation of the OCP; reducing to m inducing points caps the device-side
``k(x, X_train) @ alpha`` matvec at m rows.
"""

from __future__ import annotations

import numpy as np


class NystroemReducer:
    """Select m inducing points and re-fit targets on them.

    ``reduce(X, y)`` returns (X_m, y_m) where X_m are m rows chosen by
    k-means (cluster centers mapped to nearest samples) and y_m the
    corresponding targets — a drop-in smaller training set for `fit_gpr`.
    """

    def __init__(self, n_components: int = 100, seed: int = 0):
        self.n_components = int(n_components)
        self.seed = int(seed)

    def reduce(self, X, y) -> tuple[np.ndarray, np.ndarray]:
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float).reshape(len(X), -1)
        m = min(self.n_components, len(X))
        if m >= len(X):
            return X, y
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=m, random_state=self.seed, n_init=3).fit(X)
        idx = []
        for center in km.cluster_centers_:
            idx.append(int(np.argmin(np.sum((X - center) ** 2, axis=1))))
        idx = sorted(set(idx))
        return X[idx], y[idx]
