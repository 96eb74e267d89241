"""The benchmark's inputs, made on the device from ``--seed``: weights in the
reference layouts (the support sets of ``lib/support_sets.py``, the ResNet
reconstructor of ``lib/reconstructor.py``; the generators' in
``benchmark/families``), latent pools and training batches. The program and
the plain reference read the same tensors; nothing here imports either.
"""
from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each input, from the run's seed and a tag."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def randn_views(gen: torch.Generator, shapes: dict, device) -> dict:
    """One draw of N(0, 1) for every shape, returned as views of one buffer."""
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, offset = {}, 0
    for k, s in shapes.items():
        out[k] = flat[offset:offset + sizes[k]].view(s)
        offset += sizes[k]
    return out


def support_sets_state_dict(cfg: dict, gen: torch.Generator, device) -> dict:
    """Reference ``SupportSets`` state dict: K sets of N dipoles (each vector
    beside its antipode) on spheres of radii spanning [1, 4), alphas +1, -1,
    ..., log gamma = log(1 / d) perturbed by 10 % so that no two sets share it."""
    k, n, d = cfg["num_support_sets"], cfg["num_support_dipoles"], cfg["support_vectors_dim"]
    sv = torch.randn((k, n, d), generator=gen, device=device)
    sv = torch.stack([sv, -sv], dim=2).reshape(k, 2 * n, d)
    radii = 1.0 + 3.0 / k * torch.arange(k, dtype=torch.float32, device=device)
    sv = radii[:, None, None] * sv / torch.linalg.vector_norm(sv, dim=-1, keepdim=True)
    alphas = torch.tensor([1.0, -1.0], device=device).repeat(n).expand(k, 2 * n).contiguous()
    loggamma = math.log(1.0 / d) + 0.1 * torch.randn((k, 1), generator=gen, device=device)
    return {"SUPPORT_SETS": sv.reshape(k, 2 * n * d), "ALPHAS": alphas, "LOGGAMMA": loggamma}


def resnet_state_dict(cfg: dict, gen: torch.Generator, device) -> dict:
    """Reference ResNet reconstructor state dict (torchvision ResNet-18 with a
    6-channel conv1, features at the global pool, two linear heads): convs
    He-normal (fan out), BatchNorm scales and shifts away from 1 and 0 so
    that a dropped term shows, fresh running statistics, heads U(+-1/sqrt(512))."""
    cin = 2 * cfg["reconstructor_channels"]
    convs = {"features_extractor.conv1.weight": (64, cin, 7, 7)}
    bns = ["features_extractor.bn1"]
    ch = 64
    for li, (out, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2)), start=1):
        for b in range(2):
            p = f"features_extractor.layer{li}.{b}"
            s = stride if b == 0 else 1
            convs[p + ".conv1.weight"] = (out, ch, 3, 3)
            convs[p + ".conv2.weight"] = (out, out, 3, 3)
            bns += [p + ".bn1", p + ".bn2"]
            if s != 1 or ch != out:
                convs[p + ".downsample.0.weight"] = (out, ch, 1, 1)
                bns.append(p + ".downsample.1")
            ch = out
    widths = {}
    for name in bns:
        c = convs[name.replace("bn", "conv").replace("downsample.1", "downsample.0")
                  + ".weight"][0]
        widths[name] = c
    k = cfg["num_support_sets"]
    shapes = dict(convs)
    shapes.update({f"{n}.{p}": (c,) for n, c in widths.items() for p in ("weight", "bias")})
    shapes.update({"path_indices.weight": (k, 512), "path_indices.bias": (k,),
                   "shift_magnitudes.weight": (1, 512), "shift_magnitudes.bias": (1,)})
    r = randn_views(gen, shapes, device)
    sd = {}
    for name, s in convs.items():
        sd[name] = r[name] * math.sqrt(2.0 / (s[0] * s[2] * s[3]))
    for n, c in widths.items():
        sd[n + ".weight"] = 1.0 + 0.1 * r[n + ".weight"]
        sd[n + ".bias"] = 0.1 * r[n + ".bias"]
        sd[n + ".running_mean"] = torch.zeros(c, device=device)
        sd[n + ".running_var"] = torch.ones(c, device=device)
        sd[n + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    bound = 1.0 / math.sqrt(512)
    for name in ("path_indices.weight", "path_indices.bias", "shift_magnitudes.weight",
                 "shift_magnitudes.bias"):
        # N(0, 1) folded through its CDF into U(-bound, bound).
        sd[name] = bound * torch.erf(r[name] / math.sqrt(2.0))
    return sd


def truncated_normal(gen: torch.Generator, shape, truncation, device) -> torch.Tensor:
    """N(0, I), or truncated to [-t, t] by the inverse CDF, as float32."""
    if truncation is None or truncation == 1.0:
        return torch.randn(shape, generator=gen, device=device)
    lo = 0.5 * (1.0 + math.erf(-truncation / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(truncation / math.sqrt(2.0)))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-truncation, truncation).float()


def pool(cfg: dict, seed: int, index: int, codes: int, device) -> torch.Tensor:
    """Pool ``index`` of the render stream: (codes, dim_z) latent codes."""
    gen = generator(seed, f"pool{index}", device)
    return truncated_normal(gen, (codes, cfg["support_vectors_dim"]), cfg.get("z_truncation"),
                            device)


def train_batch(cfg: dict, seed: int, iteration: int, batch: int, device):
    """Iteration ``iteration``'s (z, path index, signed magnitude), drawn as the
    reference trainer draws them (lib/trainer.py:203-221): z (truncated when
    the experiment says so), k ~ U{0..K-1}, and B magnitudes picked without
    replacement, with probability proportional to the index, from B draws of
    U[-max, -min] followed by B of U[min, max]."""
    gen = generator(seed, f"batch{iteration}", device)
    z = truncated_normal(gen, (batch, cfg["support_vectors_dim"]), cfg.get("z_truncation"),
                         device)
    idx = torch.randint(cfg["num_support_sets"], (batch,), generator=gen, device=device)
    lo, hi = cfg["min_shift_magnitude"], cfg["max_shift_magnitude"]
    pos = lo + (hi - lo) * torch.rand(batch, generator=gen, device=device)
    neg = -lo - (hi - lo) * torch.rand(batch, generator=gen, device=device)
    weights = torch.arange(2 * batch, dtype=torch.float32, device=device)
    picked = torch.multinomial(weights, batch, replacement=False, generator=gen)
    return z, idx, torch.cat([neg, pos])[picked]
