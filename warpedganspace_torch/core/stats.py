"""Rolling training statistics tracker (reference lib/aux.py:13-36).

The port's own copy of :mod:`warpedganspace_tpu.core.stats`.
"""
from __future__ import annotations

import numpy as np

STAT_KEYS = ("accuracy", "classification_loss", "regression_loss", "total_loss")


class TrainingStatTracker:
    """Accumulates per-iteration stats; ``get_means`` averages the window and
    ``flush`` clears it. The stat names are the reference's, so ``stats.json``
    keeps its schema."""

    def __init__(self):
        self._stats = {k: [] for k in STAT_KEYS}

    def update(self, accuracy, classification_loss, regression_loss, total_loss):
        self._stats["accuracy"].append(float(accuracy))
        self._stats["classification_loss"].append(float(classification_loss))
        self._stats["regression_loss"].append(float(regression_loss))
        self._stats["total_loss"].append(float(total_loss))

    def get_means(self):
        return {k: float(np.mean(v)) if v else float("nan") for k, v in self._stats.items()}

    def flush(self):
        for k in self._stats:
            self._stats[k] = []
