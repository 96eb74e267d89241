"""BigGAN (BigGAN-PyTorch's ``G_ema`` layout): weights, the port's generator,
the plain reference, the operation counts."""
from __future__ import annotations

import torch

from benchmark.inputs import randn_views, truncated_normal
from benchmark.reference.biggan import BigGAN

# A 32x32 generator of 32 channels with its attention at 32x32, and 3 sets of
# 4 dipoles.
TINY = {"resolution": 32, "ch": 8, "attention": "32", "num_support_sets": 3,
        "num_support_dipoles": 4}
# The standing statistics' seeded batches: how many, and their rows.
STANDING = (4, 16)
# Channel multipliers of G_ch, block by block (BigGAN.py:13-52), of the
# configuration's resolution and the tiny one: the blocks' inputs and
# outputs; block i's output is 8 * 2^i pixels wide.
_TABLES = {128: ([16, 16, 8, 4, 2], [16, 8, 4, 2, 1]), 32: ([4, 4, 4], [4, 4, 4])}


def blocks(cfg: dict) -> list[tuple]:
    """(in channels, out channels, output width, attention) of each block."""
    ins, outs = _TABLES[cfg["resolution"]]
    attn = {int(a) for a in str(cfg["attention"]).split("_")}
    ch = cfg["ch"]
    return [(ch * i, ch * o, 8 * 2 ** j, 8 * 2 ** j in attn)
            for j, (i, o) in enumerate(zip(ins, outs))]


def _shapes(cfg: dict) -> dict:
    bl = blocks(cfg)
    chunk = cfg["dim_z"] // (len(bl) + 1)
    cond = cfg["shared_dim"] + chunk
    shapes = {"shared.weight": (cfg["n_classes"], cfg["shared_dim"])}

    def sn(name, shape, bias=True):
        shapes[name + ".weight"] = shape
        shapes[name + ".u0"] = (1, shape[0])
        if bias:
            shapes[name + ".bias"] = (shape[0],)
    sn("linear", (bl[0][0] * cfg["bottom_width"] ** 2, chunk))
    for j, (i, o, _, attn) in enumerate(bl):
        p = f"blocks.{j}.0."
        for bn, c in (("bn1", i), ("bn2", o)):
            sn(p + bn + ".gain", (c, cond), bias=False)
            sn(p + bn + ".bias", (c, cond), bias=False)
        sn(p + "conv1", (o, i, 3, 3))
        sn(p + "conv2", (o, o, 3, 3))
        sn(p + "conv_sc", (o, i, 1, 1))
        if attn:
            a = f"blocks.{j}.1."
            for name, (co, ci) in (("theta", (o // 8, o)), ("phi", (o // 8, o)),
                                   ("g", (o // 2, o)), ("o", (o, o // 2))):
                sn(a + name, (co, ci, 1, 1), bias=False)
            shapes[a + "gamma"] = ()
    c = bl[-1][1]
    shapes["output_layer.0.gain"] = (c,)
    shapes["output_layer.0.bias"] = (c,)
    sn("output_layer.2", (3, c, 3, 3))
    return shapes


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """A ``G_ema`` state dict drawn from ``gen``, as a trained network holds it:
    N(0, 1) weights with their ``u0`` vectors (spectral norm divides out the
    scale), biases N(0, 0.01^2), the shared embedding N(0, 1), the output
    BN's gain about 1, the attention's gamma 1 + N(0, 0.1^2) (a network's own
    init sets 0, which drops the block), and every batch norm's standing
    statistics: the mean and variance of its input averaged over the
    ``STANDING`` seeded batches of codes of the class, rendered by the
    float32 reference with TF32 and cuDNN off (cuDNN's float32 algorithms
    take 12 GB of workspace at these widths, which the card's peak memory
    would then count as set-up)."""
    shapes = _shapes(cfg)
    sd = dict(randn_views(gen, shapes, device))
    for k in shapes:
        if k.endswith(".bias"):
            sd[k] = 0.01 * sd[k]
        elif k.endswith(".gamma") or k == "output_layer.0.gain":
            sd[k] = 1.0 + 0.1 * sd[k]
    z = truncated_normal(gen, STANDING + (cfg["dim_z"],), cfg.get("z_truncation"), device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            BigGAN(sd, cfg).stand(z)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return sd


def build_program(cfg: dict, sd: dict, device):
    """The port's frozen generator, loaded through its own converter, behind
    the uniform contract (as ``models/gan_load.py::build_biggan`` builds it)."""
    from warpedganspace_torch.convert.biggan import load_reference_state_dict
    from warpedganspace_torch.models.api import GeneratorBundle
    from warpedganspace_torch.models.biggan import BigGANGenerator

    net = BigGANGenerator(resolution=cfg["resolution"], ch=cfg["ch"], dim_z=cfg["dim_z"],
                          shared_dim=cfg["shared_dim"], n_classes=cfg["n_classes"],
                          bottom_width=cfg["bottom_width"],
                          target_classes=tuple(cfg["target_classes"]),
                          attention=cfg["attention"], generator=torch.Generator().manual_seed(0))
    load_reference_state_dict(net, sd)
    net.requires_grad_(False).eval()
    return GeneratorBundle("BigGAN", net.to(device), dim_z=net.dim_z, resolution=net.resolution)


def build_reference(cfg: dict, sd: dict, q):
    return BigGAN(sd, cfg, q)


def _attention(o: int, r: int) -> tuple:
    """(N, M, dk, dv) of an attention block of ``o`` channels at ``r`` x ``r``:
    queries, pooled keys, and the widths of theta / phi and of g."""
    return r * r, r * r // 4, o // 8, o // 2


def attention_shape(cfg: dict) -> tuple:
    """(N, M, dk, dv) of the configuration's one attention block."""
    (o, r), = [(o, r) for _, o, r, attn in blocks(cfg) if attn]
    return _attention(o, r)


def frame_flops(cfg: dict) -> float:
    """One frame from Z: the first linear; in each block the four ccbn
    linears, the nearest-up 3x3 conv merged by output parity (4 taps per
    output pixel), the 3x3 conv and the 1x1 shortcut at the low resolution
    (it commutes with the nearest-up); the attention's four 1x1 projections
    at full resolution and its two products, 2 N M (dk + dv); the output
    conv."""
    bl = blocks(cfg)
    chunk = cfg["dim_z"] // (len(bl) + 1)
    cond = cfg["shared_dim"] + chunk
    total = 2 * chunk * bl[0][0] * cfg["bottom_width"] ** 2
    for i, o, r, attn in bl:
        total += 2 * 2 * cond * (i + o)
        total += 2 * r * r * (4 * i * o + 9 * o * o) + 2 * (r // 2) ** 2 * i * o
        if attn:
            n, m, dk, dv = _attention(o, r)
            total += 2 * n * o * (2 * dk + dv) + 2 * n * dv * o + 2 * n * m * (dk + dv)
    r, c = bl[-1][2], bl[-1][1]
    return total + 2 * r * r * 9 * c * 3


def forward_flops(cfg: dict) -> float:
    """One forward from Z: the frame's."""
    return frame_flops(cfg)
