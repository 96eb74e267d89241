"""Head pose of each image: SFD detection, then Hopenet on the first face.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.pose_estimator` (reference
lib/evaluation/hopenet/pose_estimator.py), a helper no CLI uses: the fixed
crop margins with the transposed x/y indexing (:55-77), then Resize(224) +
CenterCrop + ImageNet normalisation and the 66-bin heads.
"""
from __future__ import annotations

import numpy as np
import torch

from warpedganspace_torch.evalzoo import load as zoo
from warpedganspace_torch.evalzoo.hopenet import Hopenet
from warpedganspace_torch.evalzoo.transforms import crop_face, normalize_imagenet, resize_center


class PoseEstimator:
    def __init__(self, sfd=None, hopenet=None, device="cpu"):
        self.face_detector = sfd if sfd is not None else zoo.load_sfd(device=device)
        self.model_hopenet = hopenet if hopenet is not None else zoo.load_hopenet(device=device)

    @torch.no_grad()
    def calculate_pose(self, face, batch_index: int, images: torch.Tensor):
        """Crop one detected face of an (N, 3, H, W) batch and predict its
        (yaw, pitch, roll) logits."""
        crop = crop_face(images, batch_index, face[:4]) / 255.0
        crop = normalize_imagenet(resize_center(crop, 224))
        return self.model_hopenet(crop.to(self.model_hopenet.fc_yaw.weight.device))

    def detect_pose_batch(self, images: torch.Tensor):
        """(B, 3, H, W) images in [0, 255] -> (yaw, pitch, roll) in degrees, (B,) each."""
        detected_faces, _, _ = self.face_detector.detect_from_batch(images)
        yaws, pitches, rolls = [], [], []
        for i, faces in enumerate(detected_faces):
            face = (faces[0][:4] if len(faces) > 0
                    else [0, 0, images.shape[3], images.shape[2]])
            y, p, r = self.calculate_pose(np.asarray(face, dtype=float), i, images)
            yaws.append(float(Hopenet.angles_deg(y)[0]))
            pitches.append(float(Hopenet.angles_deg(p)[0]))
            rolls.append(float(Hopenet.angles_deg(r)[0]))
        return np.asarray(yaws), np.asarray(pitches), np.asarray(rolls)
