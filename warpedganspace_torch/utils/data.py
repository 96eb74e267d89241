"""Path-image loading (reference lib/data.py ``PathImages``).

Counterpart of :mod:`warpedganspace_tpu.utils.data`. Loads the sorted JPEG
frames of one traversal path as a float array in [0, 255]. The attribute stage
reads the saved (lossy, q75) JPEGs rather than generator tensors, because the
rankings depend on that round trip. Layout is (T, H, W, 3) RGB.

The JAX package decodes with cv2; the port decodes with PIL, which it already
writes its JPEGs with (``traverse/images.py``), so it needs no cv2. Both use
libjpeg's default (islow) IDCT and give the same bytes
(``tests/test_torch_evalzoo_pieces.py`` holds the two decoders equal).
"""
from __future__ import annotations

import glob
import os.path as osp

import numpy as np
from PIL import Image


class PathImages:
    def __init__(self, root_path: str):
        self.images_files = sorted(glob.glob(osp.join(root_path, "*.jpg")))

    def __len__(self) -> int:
        return len(self.images_files)

    def __getitem__(self, index: int) -> np.ndarray:
        return self.image2array(self.images_files[index])

    @staticmethod
    def image2array(image_file: str) -> np.ndarray:
        with Image.open(image_file) as img:
            rgb = np.asarray(img.convert("RGB"), dtype=np.uint8)
        return rgb.astype(np.float32)  # (H, W, 3) in [0, 255]

    def load_all(self) -> np.ndarray:
        """The whole path as one (T, H, W, 3) batch (the reference loads it as
        one batch of the path's length, traverse_attribute_space.py:298-305)."""
        return np.stack([self[i] for i in range(len(self))])
