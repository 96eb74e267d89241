"""The attribute stage's predictors (inference only).

Counterpart of :mod:`warpedganspace_tpu.evalzoo` (reference lib/evaluation/ and
traverse_attribute_space.py): SFDDetector (S3FD face detection), IDComparator
(ArcFace SE-IR-50 cosine similarity), FairFace (ResNet-34: race, gender, age),
Hopenet (yaw, pitch, roll), AUdetector (FAN-AU, 12 action-unit intensities)
and the CelebA predictor (ResNet-50 and per-attribute heads). Each network is
an ``nn.Module`` in its reference checkpoint's layout and runs in float32 on
cuDNN convolutions; the detector's anchor decode and NMS and the face
rectangles stay host numpy, as in the reference.
"""

from warpedganspace_torch.evalzoo.arcface import IDComparator
from warpedganspace_torch.evalzoo.celeba import celeba_attr_predictor
from warpedganspace_torch.evalzoo.fairface import FairFace
from warpedganspace_torch.evalzoo.fanau import AUdetector
from warpedganspace_torch.evalzoo.hopenet import Hopenet
from warpedganspace_torch.evalzoo.sfd import SFDDetector

__all__ = [
    "SFDDetector",
    "IDComparator",
    "Hopenet",
    "FairFace",
    "AUdetector",
    "celeba_attr_predictor",
]
