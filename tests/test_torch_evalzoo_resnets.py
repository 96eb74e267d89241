"""The port's three ResNet predictors (FairFace, Hopenet, CelebA) against the
JAX package's, on the CPU.

As in ``tests/test_torch_evalzoo_detect.py``: one fabricated reference-layout
state dict per network at its full architecture, loaded with
``strict=True`` into the port and as numpy into the JAX package; the same
ImageNet-normalised 224² frames from a seed; every raw output within 1e-3
relative plus 1e-4 of its largest magnitude (``-s`` prints the worst).
"""
import os.path as osp

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_evalzoo_detect import (assert_close, images, nchw, numpy_state_dict,
                                         state_dicts)
from warpedganspace_tpu.evalzoo import celeba as jceleba
from warpedganspace_tpu.evalzoo import fairface as jfair
from warpedganspace_tpu.evalzoo import hopenet as jhope
from warpedganspace_torch.evalzoo.celeba import celeba_attr_predictor
from warpedganspace_torch.evalzoo.fairface import FairFace
from warpedganspace_torch.evalzoo.hopenet import Hopenet
from warpedganspace_torch.evalzoo.load import CONFIGS_DIR
from warpedganspace_torch.evalzoo.transforms import IMAGENET_MEAN, IMAGENET_STD

torch.set_num_threads(1)


def _inputs(seed):
    x = images(seed, 2, 224, 0.0, 1.0)
    return ((x - np.float32(IMAGENET_MEAN)) / np.float32(IMAGENET_STD)).astype(np.float32)


def test_fairface_logits():
    sd = state_dicts()["fairface"]
    x = _inputs(21)
    with torch.no_grad():
        got = FairFace.from_state_dict(sd)(nchw(x)).numpy()
    want = np.asarray(jfair.FairFace.from_state_dict(numpy_state_dict(sd))(jnp.asarray(x)))
    assert got.shape == (2, 18)
    assert_close(got, want, "fairface logits")


def test_hopenet_logits_and_angles():
    sd = state_dicts()["hopenet"]
    assert "fc_finetune.weight" in sd          # in the checkpoint, never applied
    x = _inputs(22)
    with torch.no_grad():
        got = Hopenet.from_state_dict(sd)(nchw(x))
    want = jhope.Hopenet.from_state_dict(numpy_state_dict(sd))(jnp.asarray(x))
    for name, g, w in zip(("yaw", "pitch", "roll"), got, want):
        assert g.shape == (2, 66)
        assert_close(g.numpy(), np.asarray(w), f"hopenet {name} logits")
        assert_close(Hopenet.angles_deg(g).numpy(), np.asarray(jhope.Hopenet.angles_deg(w)),
                     f"hopenet {name} degrees")


def test_celeba_logits():
    sd = state_dicts()["celeba"]
    attr_file = osp.join(CONFIGS_DIR, "attributes_5.json")
    x = _inputs(23)
    with torch.no_grad():
        got = celeba_attr_predictor(attr_file, sd)(nchw(x))
    want = jceleba.CelebaAttrPredictor.from_state_dict(numpy_state_dict(sd), attr_file)(
        jnp.asarray(x))
    assert list(got) == list(want) == ["Bangs", "Eyeglasses", "No_Beard", "Smiling", "Young"]
    for attr in got:
        assert got[attr].shape == (2, 6)
        assert_close(got[attr].numpy(), np.asarray(want[attr]), f"celeba {attr} logits")
