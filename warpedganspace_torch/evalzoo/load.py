"""The six predictors from their checkpoints under ``models/pretrained/``.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.load`. The paths are the
reference layout (README.md:62-72). Each checkpoint's state dict is loaded
with ``strict=True`` into the port's module of the same layout, on ``device``.
"""
from __future__ import annotations

import os.path as osp

import torch

CONFIGS_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs")

PATHS = {
    "sfd": "models/pretrained/sfd/s3fd-619a316812.pth",
    "arcface": "models/pretrained/arcface/model_ir_se50.pth",
    "fairface": "models/pretrained/fairface/fairface_alldata_4race_20191111.pt",
    "hopenet": "models/pretrained/hopenet/hopenet_alpha2.pkl",
    "au_detector": "models/pretrained/au_detector/disfa_adaptation_f0.pth",
    "celeba": "models/pretrained/celeba_attributes/eval_predictor.pth.tar",
}


def _load(path: str) -> dict:
    if not osp.isfile(path):
        raise FileNotFoundError(f"Pretrained weights not found: {path} (run download_models.py)")
    # The reference's own checkpoint files, which may hold more than tensors.
    return torch.load(path, map_location="cpu", weights_only=False)


def _unwrap(blob: dict) -> dict:
    """The AU and CelebA files may wrap the state dict in {"state_dict": ...}."""
    return blob["state_dict"] if "state_dict" in blob else blob


def load_sfd(path: str = PATHS["sfd"], device="cpu"):
    from warpedganspace_torch.evalzoo.sfd import SFDDetector

    det = SFDDetector.from_state_dict(_load(path))
    det.net.to(device)
    return det


def load_arcface(path: str = PATHS["arcface"], device="cpu"):
    from warpedganspace_torch.evalzoo.arcface import IDComparator

    # The raw checkpoint is the bare SE-IR-50 state dict (reference arcface.py:12).
    cmp_ = IDComparator.from_state_dict(_load(path), prefix="")
    cmp_.net.to(device)
    return cmp_


def load_fairface(path: str = PATHS["fairface"], device="cpu"):
    from warpedganspace_torch.evalzoo.fairface import FairFace

    return FairFace.from_state_dict(_load(path)).to(device)


def load_hopenet(path: str = PATHS["hopenet"], device="cpu"):
    from warpedganspace_torch.evalzoo.hopenet import Hopenet

    return Hopenet.from_state_dict(_load(path)).to(device)


def load_audetector(path: str = PATHS["au_detector"], device="cpu"):
    from warpedganspace_torch.evalzoo.fanau import AUdetector

    det = AUdetector.from_state_dict(_unwrap(_load(path)))
    det.net.to(device)
    return det


def load_celeba(attr_file: str | None = None, path: str = PATHS["celeba"], device="cpu"):
    from warpedganspace_torch.evalzoo.celeba import celeba_attr_predictor

    if attr_file is None:
        attr_file = osp.join(CONFIGS_DIR, "attributes_5.json")
    return celeba_attr_predictor(attr_file, _unwrap(_load(path))).to(device)
