"""S3FD face detector: the conv tower on the device, decode and NMS on the host.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.sfd` (reference
lib/evaluation/sfd/): a VGG-style SSD tower with L2Norm-scaled feature maps
(net_s3fd.py:6-129) and a max-out background label on the stride-4 head
(:118-121); anchors decoded at strides 4..128 with score > 0.05
(detect.py:50-67); greedy NMS at IoU 0.3, then score > 0.5
(sfd_detector.py:24-41, bbox.py:44-60).

The decode and NMS are data-dependent and stay host numpy, as in the JAX
package; the NMS runs in C++ (``native/sfd_post.cpp``) where ``g++`` built it,
else in numpy. The reference's quirks are kept: ``batch_detect`` feeds raw
0-255 values with no mean subtraction (detect.py:33-75); the candidate
positions come from a threshold over the WHOLE batch and are decoded for every
frame (detect.py:55-66); ``fc6`` is a 3x3 convolution with padding 3.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warpedganspace_torch.native import load_native

_CONVS = [
    # name, in, out, kernel, stride, padding
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1),
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1),
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1),
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1),
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1),
    ("fc6", 512, 1024, 3, 1, 3), ("fc7", 1024, 1024, 1, 1, 0),
    ("conv6_1", 1024, 256, 1, 1, 0), ("conv6_2", 256, 512, 3, 2, 1),
    ("conv7_1", 512, 128, 1, 1, 0), ("conv7_2", 128, 256, 3, 2, 1),
]
_POOLED = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
# (source map, its channels, its L2Norm's initial scale or None, conf channels)
_HEADS = [("conv3_3", 256, 10.0, 4), ("conv4_3", 512, 8.0, 2), ("conv5_3", 512, 5.0, 2),
          ("fc7", 1024, None, 2), ("conv6_2", 512, None, 2), ("conv7_2", 256, None, 2)]


class L2Norm(nn.Module):
    def __init__(self, n_channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n_channels,), float(scale)))

    def forward(self, x):
        norm = x.pow(2).sum(dim=1, keepdim=True).sqrt() + 1e-10
        return x / norm * self.weight.view(1, -1, 1, 1)


def _head_names(src: str, norm) -> tuple[str, str]:
    stem = src + "_norm" if norm is not None else src
    return stem + "_mbox_conf", stem + "_mbox_loc"


class S3FD(nn.Module):
    """The tower in the reference checkpoint's layout (``conv1_1`` ... ``conv7_2``,
    ``conv{3,4,5}_3_norm``, ``*_mbox_conf``/``*_mbox_loc``)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p in _CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, k, s, p))
        for src, ch, norm, n_conf in _HEADS:
            if norm is not None:
                setattr(self, src + "_norm", L2Norm(ch, norm))
            conf, loc = _head_names(src, norm)
            setattr(self, conf, nn.Conv2d(ch, n_conf, 3, 1, 1))
            setattr(self, loc, nn.Conv2d(ch, 4, 3, 1, 1))

    def head_inputs(self, x: torch.Tensor) -> list:
        """The six maps the heads read, each after its L2Norm where it has one."""
        feats = {}
        h = x
        for name, *_ in _CONVS:
            h = F.relu(getattr(self, name)(h))
            if name in _POOLED:
                feats[name] = h
                h = F.max_pool2d(h, 2, 2)
            elif name in ("fc7", "conv6_2", "conv7_2"):
                feats[name] = h
        return [feats[src] if norm is None else getattr(self, src + "_norm")(feats[src])
                for src, _, norm, _ in _HEADS]

    def forward(self, x: torch.Tensor) -> list:
        """(B, 3, H, W) fed verbatim -> 12 NCHW maps, class then box for each
        of the six heads, the class maps softmaxed (detect.py:46-47)."""
        outs = []
        for (src, _, norm, _), f in zip(_HEADS, self.head_inputs(x)):
            conf, loc = _head_names(src, norm)
            cls = getattr(self, conf)(f)
            if src == "conv3_3":
                # Max-out background label: [max(bg0, bg1, bg2), face].
                cls = torch.cat([cls[:, :3].amax(dim=1, keepdim=True), cls[:, 3:4]], dim=1)
            outs += [torch.softmax(cls, dim=1), getattr(self, loc)(f)]
        return outs


def nms_numpy(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS (reference bbox.py:44-67), +1 area convention included."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def nms_native(lib, dets: np.ndarray, thresh: float) -> list:
    """The same NMS in C++ (``native/sfd_post.cpp``), on float32 boxes, visited
    in :func:`nms_numpy`'s order, numpy's argsort (not a stable sort: under
    equal scores no other sort keeps what it keeps)."""
    d = np.ascontiguousarray(dets, dtype=np.float32)
    order = np.ascontiguousarray(dets[:, 4].argsort()[::-1], dtype=np.int32)
    keep = np.empty(len(d), dtype=np.int32)
    n = lib.wgs_nms(d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(d),
                    ctypes.c_float(thresh), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:n].tolist()


def nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS: the C++ build where the toolchain made it, else numpy."""
    if 0 == len(dets):
        return []
    lib = load_native()
    if lib is not None:
        return nms_native(lib, dets, thresh)
    return nms_numpy(dets, thresh)


def decode(loc: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    """SSD offset decode (reference bbox.py:92-115)."""
    boxes = np.concatenate((priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:],
                            priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])), axis=1)
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def decode_batch(olist_np) -> np.ndarray:
    """Anchor decode (reference detect.py:49-75) of the 12 NCHW maps as numpy,
    with the union-over-batch candidate positions: (B, n, 5) boxes + scores."""
    bb = olist_np[0].shape[0]
    per_batch = [[] for _ in range(bb)]
    for i in range(len(olist_np) // 2):
        ocls, oreg = olist_np[i * 2], olist_np[i * 2 + 1]
        stride = 2 ** (i + 2)
        _, hidx, widx = np.where(ocls[:, 1, :, :] > 0.05)
        if hidx.size == 0:
            continue
        axc = stride / 2 + widx * stride
        ayc = stride / 2 + hidx * stride
        priors = np.stack([axc, ayc, np.full_like(axc, stride * 4.0),
                           np.full_like(axc, stride * 4.0)], axis=1).astype(np.float64)
        for j in range(bb):
            scores = ocls[j, 1, hidx, widx]
            loc = oreg[j, :, hidx, widx]        # (n, 4): the broadcast index comes first
            boxes = decode(loc.astype(np.float64), priors, [0.1, 0.2])
            per_batch[j].append(
                np.concatenate([boxes, scores[:, None].astype(np.float64)], axis=1))
    bboxlists = np.array([np.concatenate(rows, axis=0) if rows else np.zeros((0, 5))
                          for rows in per_batch])
    if 0 == len(bboxlists):
        bboxlists = np.zeros((1, 1, 5))
    return bboxlists


class SFDDetector:
    """The reference's detector API (sfd_detector.py:6-53) around an
    :class:`S3FD` on one device."""

    def __init__(self, net: S3FD, verbose: bool = False):
        self.net = net.eval()
        self.verbose = verbose

    @classmethod
    def from_state_dict(cls, sd: dict, **kwargs) -> "SFDDetector":
        net = S3FD()
        net.load_state_dict(sd, strict=True)
        return cls(net, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.net.conv1_1.weight.device

    @torch.no_grad()
    def forward_maps(self, x: torch.Tensor) -> list:
        """The tower on (B, 3, H, W) float values fed verbatim (the reference's
        batch path subtracts no means): the 12 maps on the device."""
        return self.net(x.to(self.device, torch.float32))

    def batch_detect(self, x: torch.Tensor) -> np.ndarray:
        return decode_batch([o.cpu().numpy() for o in self.forward_maps(x)])

    def detect_from_batch(self, x: torch.Tensor):
        """(bboxlists, error, error_index) as the reference returns them: per
        frame the NMS-kept boxes with score > 0.5, best first."""
        return self.detect_from_boxes(self.batch_detect(x))

    @staticmethod
    def detect_from_boxes(bboxlists: np.ndarray):
        error, error_index = False, -1
        new_bboxlists = []
        for i in range(bboxlists.shape[0]):
            bboxlist = bboxlists[i]
            keep = nms(bboxlist, 0.3)
            if len(keep) > 0:
                bboxlist = bboxlist[keep, :]
                new_bboxlists.append([x for x in bboxlist if x[-1] > 0.5])
            else:
                error, error_index = True, i
                new_bboxlists.append([])
        return new_bboxlists, error, error_index

    def detect_from_image(self, image: np.ndarray):
        """Faces in one (H, W, 3) image: the single-image path subtracts the
        means (detect.py:20-21), then NMS at 0.3 and score > 0.5."""
        x = np.asarray(image, dtype=np.float32) - np.array([104.0, 117.0, 123.0],
                                                           dtype=np.float32)
        bboxlist = self.batch_detect(torch.from_numpy(x).permute(2, 0, 1)[None])[0]
        keep = nms(bboxlist, 0.3)
        return [b for b in bboxlist[keep, :] if b[-1] > 0.5]

    @property
    def reference_scale(self):
        return 195

    @property
    def reference_x_shift(self):
        return 0

    @property
    def reference_y_shift(self):
        return 0
