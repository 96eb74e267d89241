"""Seeded predictor weights in the reference checkpoints' layout.

The repository holds no predictor checkpoint, so the tests and the card smoke
test make their own here: each of the six modules is built from a seed with
PyTorch's default initialisation, and its BatchNorm statistics are randomised
so that the normalisation is exercised. Drawn around zero and one, as the JAX
package's parity tests draw them, they leave a deep random ResNet's output
the same for every input (the signal shrinks through each convolution and the
stored means swamp it). So each BatchNorm's statistics are first those of a
calibration batch of smooth random images, as training would leave them, and
then randomised: means moved by N(0, 0.1) of their std, variances scaled by
U(0.6, 1.5). The outputs then follow the input. FairFace's and CelebA's last
layers are scaled so that their logits stay small (:func:`scale_heads`).
:func:`write_pretrained` saves the state dicts under the file names the
loaders read (``evalzoo/load.py``).

The S3FD's class and box heads are fitted, not drawn as they are, because
random heads give near ties: the tower's L2-normalised maps point almost the
same way at every position, so random face logits differ between neighbouring
anchors by a few hundredths, and two devices whose sums differ in the last
bits can then pick different first boxes. Every channel of every head reads
the frames' content: a random 3x3 direction orthogonal to its map's mean
direction, scaled to a chosen std on a calibration batch (the frames the
detector will see, or smooth random images):

- the background channels (three on the stride-4 head, whose max-out picks
  one per anchor; one on the others) have a std of ``BG_STD`` and biases drawn
  apart from each other;
- the stride-4 face logit has a std of ``FACE_STD``. Its channels are drawn
  from the directions in which the map varies inside more than near its
  border (the tower's zero padding makes the outer anchors outliers), and
  the draw is kept, then refined by a hill-climb, that puts each calibration
  frame's best anchor away from the border and furthest ahead of that
  frame's second per unit of weight (``_face_taps``): the first box moves
  with the content, and its lead is as large as the search finds. Its bias
  puts the lowest frame's best anchor at ``TOP_LOGIT``. A feature that the
  kept direction reads at a rare spike can put a few frames' best many stds
  above the rest, where a float32 softmax reads exactly 1 (from a logit of
  about 17) and two candidates tie. Where the frames' best logits spread
  over more than ``TOP_SPREAD``, the stride-4 head is drawn again from the
  same state with two background channels, and its third is a knee
  (``_knee``): below the other two wherever the face logit stays under
  ``TOP_LOGIT + TOP_SPREAD / 2``, and above it bending the face logit down
  so that the highest frame's best anchor reads ``TOP_LOGIT + TOP_SPREAD``.
  The logits under the knee, and so the decoder's candidates and the lower
  frames' leads, are those of that fit; a head whose frames spread less is
  the first fit, unchanged;
- the other five face logits (the stride-8 and stride-16 heads with an L2Norm,
  the stride-32 to 128 heads without) are centred at ``OTHER_MEAN`` with a
  std of ``OTHER_STD``: a few per cent of their anchors pass the decoder's
  0.05 threshold, so the NMS has real candidate sets, and none comes near the
  stride-4 leader;
- the box offsets have a std of ``LOC_STD``.

The card smoke test holds each frame's lead over its next candidate against
what the card moved those two scores from the CPU's.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import torch
import torch.nn.functional as F

from warpedganspace_torch.evalzoo.arcface import SEIR50
from warpedganspace_torch.evalzoo.celeba import CelebaAttrPredictor
from warpedganspace_torch.evalzoo.fairface import FairFace
from warpedganspace_torch.evalzoo.fanau import FANAU
from warpedganspace_torch.evalzoo.hopenet import Hopenet
from warpedganspace_torch.evalzoo.load import CONFIGS_DIR, PATHS
from warpedganspace_torch.evalzoo.sfd import _HEADS, S3FD, _head_names
from warpedganspace_torch.evalzoo.transforms import normalize_imagenet

FACE_STD, TOP_LOGIT, TOP_SPREAD = 2.0, 1.0, 7.0
TRIES, CLIMB, INNER, DIRECTIONS = 64, 100, 3, 32
BG_STD, OTHER_STD, OTHER_MEAN, LOC_STD = 0.5, 1.0, -5.5, 0.3


def calibrate_bn(net: torch.nn.Module, x: torch.Tensor, generator: torch.Generator) -> None:
    """BatchNorm statistics from one forward of ``x`` in train mode, then
    randomised around them. A few samples can make one feature's variance
    tiny (a BatchNorm1d sees only the batch), and that feature's scale then
    explodes on other inputs, so each layer's variances are floored at a tenth
    of its median first."""
    bns = [m for m in net.modules()
           if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None                  # a cumulative average: this batch's
    with torch.no_grad():
        net.train()(x)
    net.eval()
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.1
            m.running_var.clamp_(min=0.1 * float(m.running_var.median()))
            shape, dev = m.running_mean.shape, m.running_mean.device
            m.running_mean += (0.1 * m.running_var.sqrt()
                               * torch.randn(shape, generator=generator).to(dev))
            m.running_var *= (0.6 + 0.9 * torch.rand(shape, generator=generator)).to(dev)
            m.num_batches_tracked.zero_()


def calibration_frames(generator: torch.Generator, n: int = 2, size: int = 128) -> torch.Tensor:
    """Smooth random RGB images in [0, 255], (n, 3, size, size), each with its
    own brightness, contrast and amount of pixel noise."""
    coarse = torch.rand(n, 3, size // 16, size // 16, generator=generator)
    x = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
    gain, offset, noise = torch.rand(3, n, 1, 1, 1, generator=generator)
    x = x + 0.5 * noise * (torch.rand(n, 3, size, size, generator=generator) - 0.5)
    return 255.0 * (0.5 * offset + (0.3 + 0.7 * gain) * x).clamp(0, 1)


@torch.no_grad()
def scale_heads(layers: dict, logits: dict, limit: float = 4.0) -> None:
    """Scale each last layer so that its logits on the calibration batch stay
    within ``limit``: the attribute stage takes FairFace's and CelebA's softmax
    as exp / sum with no max shift (reference traverse_attribute_space.py:367,
    :437-467), which random logits in the hundreds would overflow."""
    for name, layer in layers.items():
        factor = min(1.0, limit / float(logits[name].abs().max()))
        layer.weight *= factor
        layer.bias *= factor


def _content_taps(f, n, std, generator):
    """``n`` random (C, 3, 3) heads over the map ``f`` (B, C, H, W), each tap
    orthogonal to the map's mean direction and each head's output scaled to
    ``std`` over ``f``."""
    mean = f.mean(dim=(0, 2, 3))
    mean_dir = mean / mean.norm()
    w = torch.randn((n, f.shape[1], 3, 3), generator=generator, dtype=torch.float64).to(f.device)
    w = w - mean_dir[None, :, None, None] * torch.einsum("nckl,c->nkl", w, mean_dir)[:, None]
    return w * (std / F.conv2d(f, w, padding=1).std(dim=(0, 2, 3)))[:, None, None, None]


def _ring(h, w, device):
    """(h, w): each position's distance in positions from the nearest border."""
    ii, jj = torch.arange(h, device=device), torch.arange(w, device=device)
    return torch.minimum(torch.minimum(ii, h - 1 - ii)[:, None], torch.minimum(jj, w - 1 - jj))


def _inner(f):
    """(H, W) mask of the positions of ``f`` that lie ``INNER`` or more from its border."""
    return _ring(*f.shape[-2:], f.device) >= INNER


def _inner_directions(f, n, generator):
    """``n`` random unit channel directions of the map ``f`` (B, C, H, W) whose
    spread inside ``_inner`` is large against their spread near the border.
    The zero padding of the tower's 3x3 convolutions puts features on the
    outer anchors that any random direction scores several times further out
    than the inner ones, so a random head's best anchor would sit on the
    border in every frame. Each direction is a random combination of the
    ``DIRECTIONS`` leading generalised eigenvectors (inner covariance against
    the border rings' second moment about the inner mean), made orthogonal
    to the inner mean so that a head's own zero padding reads the value of an
    average position."""
    x = f.permute(0, 2, 3, 1)
    mask = _inner(f)
    inner, edge = x[:, mask].flatten(0, 1), x[:, ~mask].flatten(0, 1)
    mu = inner.mean(dim=0)
    ci = torch.cov(inner.T)
    cb = (edge - mu).T @ (edge - mu) / len(edge)
    cb += 1e-6 * float(cb.diagonal().mean()) * torch.eye(len(cb), dtype=cb.dtype, device=cb.device)
    lower_inv = torch.linalg.inv(torch.linalg.cholesky(cb))
    _, vecs = torch.linalg.eigh(lower_inv @ ci @ lower_inv.T)
    basis = lower_inv.T @ vecs[:, -DIRECTIONS:]                      # (C, DIRECTIONS)
    mix = torch.randn((DIRECTIONS, n), generator=generator, dtype=torch.float64).to(f.device)
    v = (basis @ mix).T                                              # (n, C)
    mu_dir = mu / mu.norm()
    v = v - (v @ mu_dir)[:, None] * mu_dir
    return v / v.norm(dim=1, keepdim=True)


def _inner_taps(f, n, std, generator):
    """``n`` random (C, 3, 3) heads over ``f``, each an ``_inner_directions``
    direction times a random 3x3 stencil, scaled to ``std`` inside (the
    stride-4 background channels: drawn over the whole map, their border
    outliers would swamp their spread inside)."""
    v = _inner_directions(f, n, generator)
    stencil = torch.randn((n, 3, 3), generator=generator, dtype=torch.float64).to(f.device)
    w = v[:, :, None, None] * stencil[:, None]
    out = F.conv2d(f, w, padding=1)[:, :, _inner(f)]
    return w * (std / out.std(dim=(0, 2)))[:, None, None, None]


def _face_taps(f, background, generator):
    """The stride-4 face head over ``f`` (B, C, H, W) against ``background``
    (B, 1, H, W): (its (C, 3, 3) weights, each frame's best logit (B,)).

    The head is a direction ``v`` times one random 3x3 stencil, scaled so that
    its logits have a std of ``FACE_STD`` inside. Of ``TRIES`` directions the
    one is kept that puts the fewest frames' best anchor within ``2 * INNER``
    of the border, then the worst frame's best anchor furthest ahead of its
    second per unit of weight (a device's rounding moves a logit in proportion
    to the weights' norm). ``CLIMB`` steps then move ``v`` towards the
    feature differences between the best and second anchors of the worst
    eighth of the frames, each step kept only where it raises that lead and
    puts no more best anchors near the border."""
    b, c = f.shape[:2]
    inner = _inner(f).flatten()
    ring = _ring(*f.shape[-2:], f.device).flatten()
    stencil = torch.randn((3, 3), generator=generator, dtype=torch.float64).to(f.device)
    h = F.conv2d(f, stencil.expand(c, 1, 3, 3).contiguous(), padding=1, groups=c).flatten(2)
    bg = background.flatten(1)

    def assess(v):
        """Per direction (n, C): border count, lead per weight, scale, the
        best and second anchors (n, B, 2), the frames' leads (n, B)."""
        raw = torch.einsum("bcp,nc->nbp", h, v)
        scale = FACE_STD / raw[:, :, inner].std(dim=(1, 2))
        top2 = (scale[:, None, None] * raw - bg).topk(2)
        leads = top2.values[..., 0] - top2.values[..., 1]
        outside = (ring[top2.indices[..., 0]] < 2 * INNER).sum(dim=1)
        return outside, leads.amin(dim=1) / scale, scale, top2.indices, leads

    tries = _inner_directions(f, TRIES, generator)
    outside, per_weight, *_ = assess(tries)
    v = tries[int((per_weight - 1e3 * outside).argmax())][None]
    best = assess(v)
    mu = f.mean(dim=(0, 2, 3))
    mu_dir = mu / mu.norm()
    step = 0.05
    for _ in range(CLIMB):
        _, _, _, top2, leads = best
        worst = leads[0].argsort()[:max(1, b // 8)]
        d = (h[worst, :, top2[0, worst, 0]] - h[worst, :, top2[0, worst, 1]]).sum(dim=0)
        d = d - (d @ mu_dir) * mu_dir
        u = v + step * d / d.norm()
        u = u / u.norm()
        trial = assess(u)
        if trial[0] <= best[0] and trial[1] > best[1]:
            v, best, step = u, trial, 1.2 * step
        else:
            step *= 0.5
    _, _, scale, top2, _ = best
    logits = scale[0] * torch.einsum("bcp,c->bp", h, v[0]) - bg
    return float(scale[0]) * v[0][:, None, None] * stencil, logits.amax(dim=1)


def _knee(face: torch.Tensor, drawn: torch.Tensor, knee: float) -> float:
    """``alpha`` of the stride-4 head's knee channel, ``alpha * (face - knee)
    + (1 - alpha) * drawn[:, 0]``, over its face logits ``face`` (B, 1, H, W)
    and its drawn background channels ``drawn`` (B, 2, H, W), biases
    included. Where the face logit ``face - max(drawn)`` is under ``knee`` the
    channel lies below ``max(drawn)`` whatever ``alpha``; above it the max-out
    takes the channel, and where ``drawn[:, 0]`` was the max the face logit
    rises as ``knee + (1 - alpha) * (logit - knee)``. The least ``alpha``
    that brings the highest frame's best anchor to ``TOP_LOGIT +
    TOP_SPREAD``, or 0 (the channel repeats ``drawn[:, 0]``) where no frame's
    best reads more."""
    top = TOP_LOGIT + TOP_SPREAD
    background = drawn.amax(dim=1, keepdim=True)

    def highest(alpha):
        bent = alpha * (face - knee) + (1 - alpha) * drawn[:, :1]
        return float((face - torch.maximum(background, bent)).max())

    if highest(0.0) <= top:
        return 0.0
    lo, hi = 0.0, 1.0
    for _ in range(40):                  # the highest best falls as alpha rises
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if highest(mid) <= top else (mid, hi)
    return hi


def _drawn_background(f, n, stride4, generator):
    """``n`` drawn background channels over ``f``: (weights, biases, their
    outputs (B, n, H, W))."""
    bg = (_inner_taps if stride4 else _content_taps)(f, n, BG_STD, generator)
    bg_bias = (BG_STD * torch.randn(n, generator=generator, dtype=torch.float64)).to(f.device)
    return bg, bg_bias, F.conv2d(f, bg, bg_bias, padding=1)


@torch.no_grad()
def set_sfd_heads(net: S3FD, frames: torch.Tensor, generator: torch.Generator) -> None:
    """Set the class and box heads of ``net`` from ``frames`` (B, 3, H, W) in
    [0, 255] on the net's device, as the module docstring says."""
    dev = next(net.parameters()).device
    maps = [f.double() for f in net.head_inputs(frames.to(dev, torch.float32))]
    for (src, _, norm, n_conf), f in zip(_HEADS, maps):
        conf, loc = (getattr(net, n) for n in _head_names(src, norm))
        stride4 = src == "conv3_3"
        start = generator.get_state()
        bg, bg_bias, drawn = _drawn_background(f, n_conf - 1, stride4, generator)
        background = drawn.amax(dim=1, keepdim=True)
        if stride4:
            face, best = _face_taps(f, background, generator)
            kneed = float(best.max() - best.min()) > TOP_SPREAD
            if kneed:                    # drawn again with two, the third the knee
                generator.set_state(start)
                bg, bg_bias, drawn = _drawn_background(f, n_conf - 2, True, generator)
                face, best = _face_taps(f, drawn.amax(dim=1, keepdim=True), generator)
            bias = TOP_LOGIT - float(best.min())
            if kneed:
                knee = TOP_LOGIT + TOP_SPREAD / 2
                a = _knee(F.conv2d(f, face[None], padding=1) + bias, drawn, knee)
                bg = torch.cat([bg, (a * face + (1 - a) * bg[0])[None]])
                bg_bias = torch.cat([bg_bias, a * (bias - knee) + (1 - a) * bg_bias[:1]])
        else:
            face = _content_taps(f, 1, OTHER_STD, generator)[0]
            bias = OTHER_MEAN - float((F.conv2d(f, face[None], padding=1) - background).mean())
        conf.weight.copy_(torch.cat([bg, face[None]]).float())
        conf.bias.copy_(torch.cat([bg_bias, bg_bias.new_tensor([bias])]).float())
        loc.weight.copy_(_content_taps(f, 4, LOC_STD, generator).float())
        loc.bias.zero_()


def build_predictors(seed: int = 0, calibration: torch.Tensor | None = None,
                     device="cpu") -> dict:
    """The six modules, keyed as ``evalzoo/load.py::PATHS``, on ``device``.
    ``calibration``: the frames that set the S3FD's heads (default: smooth
    random images from the seed)."""
    generator = torch.Generator().manual_seed(seed)
    with open(osp.join(CONFIGS_DIR, "attributes_5.json")) as f:
        attr_info = json.load(f)["attr_info"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = {"sfd": S3FD(), "arcface": SEIR50(), "fairface": FairFace(),
                "hopenet": Hopenet(), "au_detector": FANAU(),
                "celeba": CelebaAttrPredictor(attr_info)}
    for net in nets.values():
        net.to(device)
    if calibration is None:
        calibration = calibration_frames(generator)
    # Each network's calibration input as the attribute stage prepares it
    # (smaller than the stage's 224² and 256² where the network takes any
    # size: the statistics are per channel).
    images = calibration_frames(generator, n=8, size=160).to(device) / 255.0
    imagenet = normalize_imagenet(images)
    inputs = {"arcface": F.interpolate(images * 2.0 - 1.0, size=(112, 112), mode="bilinear"),
              "au_detector": F.interpolate(images, size=(128, 128), mode="bilinear"),
              "fairface": imagenet, "hopenet": imagenet,
              # CelebA reads [-1, 1]-scaled frames for StyleGAN2, [0, 1] for the others.
              "celeba": torch.cat([imagenet, normalize_imagenet(images * 2.0 - 1.0)])}
    for name, x in inputs.items():
        calibrate_bn(nets[name], x, generator)
    celeba = nets["celeba"]
    with torch.no_grad():
        scale_heads({a: getattr(celeba, n)[1] for a, n in celeba.head_names.items()},
                    celeba(inputs["celeba"]))
        scale_heads({"fc": nets["fairface"].fc}, {"fc": nets["fairface"](inputs["fairface"])})
    nets["sfd"].eval()
    set_sfd_heads(nets["sfd"], calibration, generator)
    return nets


def predictor_state_dicts(seed: int = 0, calibration: torch.Tensor | None = None,
                          device="cpu") -> dict:
    """{name: state dict on the CPU} of :func:`build_predictors`."""
    return {name: {k: v.detach().cpu() for k, v in net.state_dict().items()}
            for name, net in build_predictors(seed, calibration, device).items()}


def write_pretrained(root: str, state_dicts: dict) -> dict:
    """Save ``state_dicts`` under ``root`` at the loaders' paths (the AU and
    CelebA files wrapped in {"state_dict": ...}, as the reference's are).
    Returns {name: path}."""
    paths = {}
    for name, sd in state_dicts.items():
        path = osp.join(root, PATHS[name])
        os.makedirs(osp.dirname(path), exist_ok=True)
        torch.save({"state_dict": sd} if name in ("au_detector", "celeba") else sd, path)
        paths[name] = path
    return paths
