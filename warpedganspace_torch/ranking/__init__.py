"""Interpretable-path ranking by attribute-vs-step correlation."""

from warpedganspace_torch.ranking.engine import (
    ATTRIBUTE_GROUPS,
    ATTRIBUTE_RANGES,
    l1_normalize_rows,
    path_attribute_correlations,
)

__all__ = [
    "ATTRIBUTE_GROUPS",
    "ATTRIBUTE_RANGES",
    "l1_normalize_rows",
    "path_attribute_correlations",
]
