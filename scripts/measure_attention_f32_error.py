"""How far the f32 attention kernels lie from float64, and in which direction, on the card.

At BigGAN-128's training shape (B=32, N=4096, M=1024, dk=24, dv=96) the
forward's output and the backward's three gradients of four f32 routes are
held to the same function in float64: the shipped split-precision design
(``ops/attn_cuda.py``), the same design built with its accumulators never
added into the outputs before the end (one chain of ``mma.sync`` over all of
M or N: the tensor cores' float32 accumulation rounds toward zero), the
CUDA-core design it replaced (its own C entries), and the plain PyTorch
versions (TF32 off). Each line gives the largest error against the largest
entry, the root-mean-square error against the root-mean-square entry, and the
mean signed error along the reference's sign against the mean magnitude: a
negative mean is a result shrunk toward zero.

Then the forward's saved lse against float64 at dk = 12, 24, 48, 96 and 192
(B=4, N=M=1024, dv=96): the shipped design, the same with its logits summed in
one chain of ``mma.sync`` over all the k8 steps at every dk (the shipped
design does so up to dk=32 only), the CUDA-core design and the plain float32
logsumexp (TF32 off); each line gives the largest absolute error, the mean
signed error and the largest |lse|.

    PYTHONPATH=. python scripts/measure_attention_f32_error.py

Needs an NVIDIA card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import ablate_attention_cuda as A
from warpedganspace_torch.ops import attn_cuda, attn_cuda_cores
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

SHAPE = (32, 4096, 1024, 24, 96)   # B, N, M, dk, dv
LSE_SHAPE = (4, 1024, 1024, 96)     # B, N, M, dv
LSE_DKS = (12, 24, 48, 96, 192)
# The shipped forward with its logits in one chain over the k8 steps at every dk.
LOGITS_CHAIN = [("        mma3_records_add<8>(s, a, bq, 8);\n",
                 "        mma3_records<8>(s, a, bq, 8);\n")]


def errors(got, want) -> str:
    e = got.double() - want
    w = want.abs()
    return (f"max {float(e.abs().max() / w.max()):.3g}, rms "
            f"{float(e.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()):.3g}, signed mean "
            f"{float((e * want.sign()).mean() / w.mean()):.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_attention_f32_error: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    b, n, m, dk, dv = SHAPE
    gen = torch.Generator().manual_seed(0)
    theta = torch.randn((b, n, dk), generator=gen).cuda()
    phi = torch.randn((b, m, dk), generator=gen).cuda()
    g = (torch.rand((b, m, dv), generator=gen) * 2 - 1).cuda()
    ct = torch.randn((b, n, dv), generator=gen).cuda()
    th, ph, gd, cd = (t.double() for t in (theta, phi, g, ct))
    beta = torch.softmax(torch.bmm(th, ph.transpose(1, 2)), -1)
    want = [torch.bmm(beta, gd)]
    dbeta = torch.bmm(cd, gd.transpose(1, 2))
    ds = beta * (dbeta - (dbeta * beta).sum(-1, keepdim=True))
    want += [torch.bmm(ds, ph), torch.bmm(ds.transpose(1, 2), th),
             torch.bmm(beta.transpose(1, 2), cd)]
    del beta, dbeta, ds

    fwd_lib, bwd_lib = (
        fn(ctypes.CDLL(A._build_variant(source, "f32 no flushes", [], A.TF_NO_FLUSH)[0]))
        for fn, source in ((A._fwd_fn, "sa_attention.cu"), (A._bwd_fn, "sa_attention_bwd.cu")))
    stream = torch.cuda.current_stream().cuda_stream

    def no_flush():
        out = torch.empty((b, n, dv), device="cuda")
        lse = torch.empty((b, n), device="cuda")
        rdot = torch.empty((b, n), device="cuda")
        grads = [torch.empty_like(t) for t in (theta, phi, g)]
        errs = (fwd_lib(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), 0, b, n, m, dk, dv, stream),
                bwd_lib(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                        ct.data_ptr(), lse.data_ptr(), rdot.data_ptr(),
                        *(t.data_ptr() for t in grads), 0, b, n, m, dk, dv, stream))
        if any(errs):
            raise RuntimeError(f"the variant without flushes failed to launch: {errs}")
        return [out] + grads

    def shipped():
        saved = attn_cuda.sa_attention_saved(theta, phi, g)
        return [saved[0], *attn_cuda.sa_attention_bwd(theta, phi, g, ct, saved=saved)]

    def cuda_cores():
        saved = attn_cuda_cores.cc_forward(theta, phi, g, want_lse=True)
        return [saved[0], *attn_cuda_cores.cc_backward(theta, phi, g, *saved, ct)]

    def plain():
        return [sa_attention_plain(theta, phi, g), *sa_attention_bwd_plain(theta, phi, g, ct)]

    routes = {f"shipped ({attn_cuda.design(torch.float32)})": shipped,
              "the same without flushes": no_flush, "CUDA-core design": cuda_cores,
              "plain (TF32 off)": plain}
    for route, fn in routes.items():
        got = fn()
        torch.cuda.synchronize()
        for name, a, w in zip(("out", "dtheta", "dphi", "dg"), got, want):
            print(f"[f32 error vs float64, B={b}] {route}, {name}: {errors(a, w)}; on {card}")
    del theta, phi, g, ct, th, ph, gd, cd, want
    lse_errors(card)
    return 0


def lse_errors(card: str) -> None:
    chain = A._fwd_fn(ctypes.CDLL(A._build_variant("sa_attention.cu", "f32 logits in one chain",
                                                   LOGITS_CHAIN, [])[0]))
    b, n, m, dv = LSE_SHAPE
    for dk in LSE_DKS:
        gen = torch.Generator().manual_seed(1)
        theta = torch.randn((b, n, dk), generator=gen).cuda()
        phi = torch.randn((b, m, dk), generator=gen).cuda()
        g = (torch.rand((b, m, dv), generator=gen) * 2 - 1).cuda()
        want = torch.logsumexp(torch.bmm(theta.double(), phi.double().transpose(1, 2)), -1)

        def one_chain():
            out = torch.empty((b, n, dv), device="cuda")
            lse = torch.empty((b, n), device="cuda")
            err = chain(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), 0, b, n, m, dk, dv, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the variant in one chain failed to launch: {err}")
            return lse

        routes = {"shipped": lambda: attn_cuda.sa_attention_saved(theta, phi, g)[1],
                  "logits in one chain": one_chain,
                  "CUDA-core design": lambda: attn_cuda_cores.cc_forward(theta, phi, g, True)[1],
                  "plain (TF32 off)": lambda: torch.logsumexp(
                      torch.bmm(theta, phi.transpose(1, 2)), -1)}
        for route, fn in routes.items():
            e = fn().double() - want
            torch.cuda.synchronize()
            print(f"[f32 lse vs float64, B={b} N={n} M={m} dk={dk}] {route}: max "
                  f"{float(e.abs().max()):.3g}, signed mean {float(e.mean()):.3g}, |lse| up to "
                  f"{float(want.abs().max()):.4g}; on {card}")


if __name__ == "__main__":
    sys.exit(main())
