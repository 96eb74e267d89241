"""Path-ranking math, in numpy.

The port's own copy of :mod:`warpedganspace_tpu.ranking.engine` (reference
``rank_interpretable_paths.py``). It stays on the host: at the largest size
the scripts give it (6 codes x 200 paths x 12 attributes x 61 points) it is a
few hundred thousand numbers, no work worth a device.

Given the attribute traversal arrays produced by traverse_attribute_space
(eval_np/<attr>.npy, each [num_paths, num_points]), ranks each path by the
correlation between the attribute sequence and the traversal step index
(:391-398): corr[s, k, a] = cov(A_t, idx) / sqrt(var(idx)), with attributes
pre-scaled/clipped to [-1, 1] via per-attribute ranges (:52-85, :382-386) and
a V-shaped index for the identity attribute (distance from the center frame).
"""
from __future__ import annotations

import numpy as np

# Attribute groups (reference :25-49). Editable the same way.
ATTRIBUTE_GROUPS = {
    "DEV": ("au_12_Lip_Corner_Puller", "identity"),
    "Face-W": ("face_width", "identity"),
    "Face-H": ("face_height", "identity"),
    "Face-WH": ("face_width", "face_height", "identity"),
    "Age-FareFace": ("age", "identity", "gender", "race"),
    "Age-CelebA": ("celeba_age", "identity", "gender", "race"),
    "Gender": ("gender", "race", "age", "celeba_age"),
    "Rotation": ("yaw", "pitch", "roll", "identity", "age", "celeba_age", "race",
                 "gender", "celeba_bangs", "celeba_beard", "celeba_eyeglasses",
                 "celeba_smiling"),
    "Smiling-AU12": ("au_12_Lip_Corner_Puller", "identity", "gender", "age", "race"),
    "Smiling-CelebA": ("celeba_smiling", "identity", "gender", "age", "race"),
    "Brow-Lowerer-AU4": ("au_4_Brow_Lowerer", "identity", "gender", "age", "race"),
    "Bangs": ("celeba_bangs", "identity"),
}

# Per-attribute min-max ranges (reference :52-85).
ATTRIBUTE_RANGES = {
    "face_width": (0.0, 1.0),
    "face_height": (0.0, 1.0),
    "identity": (0.0, 1.0),
    "yaw": (-1.1, 1.1),
    "pitch": (-0.5, 0.5),
    "roll": (-0.3, 0.3),
    "race": (0.0, 1.0),
    "age": (0.0, 1.0),
    "gender": (0.0, 1.0),
    "au_1_Inner_Brow_Raiser": (0.0, 5.0),
    "au_2_Outer_Brow_Raiser": (0.0, 5.0),
    "au_4_Brow_Lowerer": (0.0, 5.0),
    "au_5_Upper_Lid_Raiser": (0.0, 5.0),
    "au_6_Cheek_Raiser": (0.0, 5.0),
    "au_9_Nose_Wrinkler": (0.0, 5.0),
    "au_12_Lip_Corner_Puller": (0.0, 5.0),
    "au_15_Lip_Corner_Depressor": (0.0, 5.0),
    "au_17_Chin_Raiser": (0.0, 5.0),
    "au_20_Lip_stretcher": (0.0, 5.0),
    "au_25_Lips_part": (0.0, 5.0),
    "au_26_Jaw_Drop": (0.0, 5.0),
    "celeba_bangs": (0.0, 1.0),
    "celeba_beard": (0.0, 1.0),
    "celeba_eyeglasses": (0.0, 1.0),
    "celeba_smiling": (0.0, 1.0),
    "celeba_age": (0.0, 1.0),
}


def l1_normalize_rows(x: np.ndarray) -> np.ndarray:
    """Row-wise L1 normalization (reference ``l1``, :88-94).

    Like the reference, an all-zero row (a path whose every attribute sequence
    is constant) divides by zero and yields NaN — preserved for output parity;
    pandas ``sort_values`` places NaNs last, so rankings stay well-defined.
    """
    return x / np.abs(x).sum(axis=1, keepdims=True)


def path_attribute_correlations(
    attributes_array: np.ndarray, attribute_names, ranges: dict | None = None
) -> np.ndarray:
    """Correlation of each attribute sequence with the step index.

    Args:
        attributes_array: [num_samples, num_paths, num_attributes, num_points].
        attribute_names:  names aligned with axis 2.
        ranges:           optional per-attribute (min, max) overrides.

    Returns:
        [num_samples, num_paths, num_attributes] correlations (NOT averaged or
        absolute-valued — callers apply mean-over-samples and |.| as the
        reference does, :401, :436).
    """
    ranges = ranges or ATTRIBUTE_RANGES
    names = list(attribute_names)
    s_n, k_n, a_n, t_n = attributes_array.shape
    lo = np.array([ranges[a][0] for a in names])
    hi = np.array([ranges[a][1] for a in names])

    scaled = 2.0 * (attributes_array - lo[None, None, :, None]) / (
        hi - lo
    )[None, None, :, None] - 1.0
    scaled = np.clip(scaled, -1.0, 1.0)

    idx = np.arange(t_n)
    # Identity uses the V-shaped index — distance from the center frame
    # (reference :394-397).
    v_idx = np.concatenate([-1 * np.arange(-t_n // 2 + 1, 0), np.arange(t_n // 2 + 1)])
    # One [a, t] index matrix (identity rows get the V index), then the whole
    # cov(A_t, idx)/sqrt(var(idx)) tensor as a single einsum over t — replaces
    # the reference's per-(sample, path, attribute) np.cov loop with identical
    # ddof=1 semantics (np.cov default).
    idx_mat = np.stack([v_idx if a == "identity" else idx for a in names]).astype(float)
    idx_c = idx_mat - idx_mat.mean(axis=-1, keepdims=True)
    seq_c = scaled - scaled.mean(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = np.einsum("skat,at->ska", seq_c, idx_c) / (t_n - 1)
        idx_std = np.sqrt((idx_c**2).sum(axis=-1) / (t_n - 1))
        return cov / idx_std[None, None, :]
