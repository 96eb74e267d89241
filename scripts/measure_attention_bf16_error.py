"""How far the bf16 attention kernels lie from float64, and in which direction, on the card.

The tensor cores' float32 accumulation rounds toward zero, so a long chain of
``mma.sync`` shrinks a sum. At BigGAN-128's shapes (the forward at B=16, the
backward at the training batch B=32; N=4096, M=1024, dk=24, dv=96) the bf16
forward's output and row log-sum-exp and the bf16 backward's three gradients
are held to the same function in float64 on the same bf16 operands, pooled
over ``--seeds`` draws, for these routes:

- the shipped designs (``ops/attn_cuda.py``; the backward adds each lane's
  accumulators into f32 sums of its own every ``kSumChunks`` = 4 chunks);
- the backward built from the same source with its sums every chunk, and
  never (one chain of ``mma.sync`` over all of M or N: the design before the
  sums), each after the shipped forward;
- the plain bf16 versions (``ops/attn.py``; their products in float32, TF32
  off) and, for lse, the float32 logsumexp of float32 logits.

Each line gives the largest error against the largest entry, and the signed
mean error (the mean error along the reference's sign against its mean
magnitude: negative is a result shrunk toward zero) with its standard error
over the elements. Then each backward is timed with CUDA events in turns.

    PYTHONPATH=. python scripts/measure_attention_bf16_error.py [--seeds 4]

Needs an NVIDIA card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import ablate_attention_cuda as A
from warpedganspace_torch.ops import attn_cuda
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

FWD_SHAPE = (16, 4096, 1024, 24, 96)   # B, N, M, dk, dv
BWD_SHAPE = (32, 4096, 1024, 24, 96)
# The bf16 backward built with another interval of its sums.
SUMS = "constexpr int kSumChunks = 4;"
VARIANTS = {"sums every chunk": 1, "no sums (one chain)": 1 << 30}


class Pooled:
    """Errors of one output against float64, pooled over draws."""

    def __init__(self):
        self.signed = self.mag = self.sq = self.n = self.worst = self.top = 0.0

    def add(self, got, want):
        e = (got.double() - want) * want.sign()
        self.signed += float(e.sum())
        self.sq += float((e * e).sum())
        self.n += e.numel()
        self.mag += float(want.abs().sum())
        self.worst = max(self.worst, float(e.abs().max()))
        self.top = max(self.top, float(want.abs().max()))

    def text(self) -> str:
        mean = self.signed / self.n
        se = math.sqrt(max(self.sq / self.n - mean * mean, 0.0) / self.n) * self.n / self.mag
        return (f"max {self.worst / self.top:.3g} of the largest entry, signed mean "
                f"{self.signed / self.mag:.3g} (standard error {se:.2g})")


def inputs(shape, seed):
    b, n, m, dk, dv = shape
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((b, n, dk), generator=gen)
    phi = torch.randn((b, m, dk), generator=gen)
    g = torch.rand((b, m, dv), generator=gen) * 2 - 1
    ct = torch.randn((b, n, dv), generator=gen)
    return tuple(t.to("cuda", torch.bfloat16) for t in (theta, phi, g, ct))


def f64_forward(theta, phi, g):
    s = theta.double() @ phi.double().transpose(1, 2)
    lse = s.logsumexp(-1)
    return (s - lse[..., None]).exp() @ g.double(), lse


def f64_backward(theta, phi, g, ct):
    th, ph, gd, cd = (t.double() for t in (theta, phi, g, ct))
    beta = (th @ ph.transpose(1, 2)).softmax(-1)
    dbeta = cd @ gd.transpose(1, 2)
    ds = beta * (dbeta - (dbeta * beta).sum(-1, keepdim=True))
    del dbeta
    return ds @ ph, ds.transpose(1, 2) @ th, beta.transpose(1, 2) @ cd


def variant_backward(bwd):
    """The shipped forward, then a built backward variant by its C entry."""

    def backward(theta, phi, g, ct):
        b, n, dk = theta.shape
        m, dv = g.shape[1:]
        out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
        rdot = torch.empty((b, n), device="cuda")
        grads = [torch.empty_like(t) for t in (theta, phi, g)]
        err = bwd(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(), ct.data_ptr(),
                  lse.data_ptr(), rdot.data_ptr(), *(t.data_ptr() for t in grads), 1, b, n, m,
                  dk, dv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"a backward variant failed to launch: {err}")
        return grads

    return backward


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4, help="draws of the operands")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_attention_bf16_error: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)

    def build(item):
        name, chunks = item
        edit = [(SUMS, f"constexpr int kSumChunks = {chunks};")]
        return name, A._bwd_fn(ctypes.CDLL(A._build_variant("sa_attention_bwd.cu", name, edit,
                                                            [])[0]))

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(pool.map(build, VARIANTS.items()))
    # (forward or None, backward) of each route.
    routes = {"shipped": (lambda th, ph, g: attn_cuda.sa_attention_saved(th, ph, g),
                          lambda th, ph, g, ct: attn_cuda.sa_attention_bwd(th, ph, g, ct))}
    routes.update({name: (None, variant_backward(lib)) for name, lib in built.items()})
    routes["plain bf16"] = (
        lambda th, ph, g: (sa_attention_plain(th, ph, g),
                           torch.logsumexp(th.float() @ ph.float().transpose(1, 2), -1)),
        sa_attention_bwd_plain)

    fwd_err = {r: {"out": Pooled(), "lse": Pooled()} for r, (fwd, _) in routes.items() if fwd}
    bwd_err = {r: {k: Pooled() for k in ("dtheta", "dphi", "dg")} for r in routes}
    with torch.no_grad():
        for seed in range(args.seeds):
            theta, phi, g, _ = inputs(FWD_SHAPE, seed)
            want = f64_forward(theta, phi, g)
            for r in fwd_err:
                for (name, pooled), got in zip(fwd_err[r].items(), routes[r][0](theta, phi, g)):
                    pooled.add(got, want[name == "lse"])
            del want
            theta, phi, g, ct = inputs(BWD_SHAPE, 100 + seed)
            want = f64_backward(theta, phi, g, ct)
            for r, (_, bwd) in routes.items():
                for pooled, got, w in zip(bwd_err[r].values(), bwd(theta, phi, g, ct), want):
                    pooled.add(got, w)
            del want
    for r in routes:
        for name, p in list(fwd_err.get(r, {}).items()) + list(bwd_err[r].items()):
            shape = FWD_SHAPE if name in ("out", "lse") else BWD_SHAPE
            print(f"[bf16 error vs float64, {args.seeds} draws at B={shape[0]}] {r}, {name}: "
                  f"{p.text()}; on {card}")

    # Each built backward in turns, shipped first and last (each after the forward).
    theta, phi, g, ct = inputs(BWD_SHAPE, 100)
    calls = {r: (lambda f=routes[r][1]: f(theta, phi, g, ct)) for r in routes if r != "plain bf16"}
    for r, ts in A._time_in_turns(calls, iters=10).items():
        print(f"[bf16 forward + backward B={BWD_SHAPE[0]}] {r}: {sum(ts) / len(ts):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in ts)}); on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
