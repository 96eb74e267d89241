"""The port's data parallelism on the card.

- SyncBN on two gloo ranks that share one card (CUDA tensors; NCCL refuses
  two ranks on one card) against the port's BatchNorm in one process on the
  card, at the gates of ``tests/test_torch_parallel.py``.
- One NCCL rank: a data-parallel state trained by graphed chunks of
  ``--steps-per-call`` (the all-reduces of the gradients, the BatchNorm
  moments and the metrics captured in the CUDA graph and replayed) against the
  same state trained by eager steps, for SNGAN-MNIST, a small BigGAN and the
  1024² experiments' families at the small sizes of
  ``tests/test_torch_train_graph_cuda.py`` (a 256² StyleGAN2 in W space and
  the tiny ProgGAN chain, their tail kernels launching in the graph), with
  the rule of
  ``tests/test_torch_train_graph_cuda.py``: bit-equal when the eager step
  repeats its own bits, else as close as a second eager run.
- ``traverse_latent_space --multi-device`` on two gloo ranks that share the
  card: one StyleGAN2-W code (the 256² generator of
  ``tests/test_torch_train_graph_cuda.py``, bf16, through the warp and tail
  kernels) whose render batches the ranks split, each its contiguous block;
  the tree is the one one process writes on the card, byte for byte.

These cases need an NVIDIA card (and ``nvcc`` for BigGAN's attention
kernels); elsewhere they skip. The file imports no JAX, so on a machine
without it run it past the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_parallel_cuda.py
"""
import json
import os
import os.path as osp
import shutil

import pytest
import torch

# The test directory is on the path (pytest's rootdir insertion, and the
# script's own directory in the ranks): named plainly, these resolve there
# even where another installed package is called ``tests``.
from test_torch_train_graph_cuda import SPREAD, _bit_equal, _close_as_eager, _generator
from torch_ranks import spawn
from warpedganspace_torch.models.reconstructor import BatchNorm

pytestmark = pytest.mark.gpu

_BF16 = 2 ** -7                          # one bfloat16 step of the largest magnitude
# (rtol, atol, atol as a share of the largest magnitude), as on the CPU but
# for the parameter gradients, sums of 16 x 9 x 9 products a channel here:
# 1e-5 of their largest magnitude in f32.
_F32 = (0.0, 1e-5, 0.0)
GATES = {"f32": {"y": _F32, "x_grad": _F32, "weight_grad": (0.0, 0.0, 1e-5),
                 "bias_grad": (0.0, 0.0, 1e-5), "running_mean": _F32, "running_var": _F32},
         "bf16": {"y": (0.0, 0.0, _BF16), "x_grad": (0.0, 0.0, _BF16),
                  "weight_grad": (0.0, 0.0, 2 * _BF16), "bias_grad": (0.0, 0.0, 2 * _BF16),
                  "running_mean": _F32, "running_var": _F32}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_sync_bn_two_ranks_on_one_card(cuda, tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 64, 9, 9, generator=g) * 2.0 + 1.0
    inputs = {"x_f32": x, "x_bf16": x.bfloat16(),
              "state": {"weight": 1.0 + 0.5 * torch.rand(64, generator=g),
                        "bias": 0.3 * torch.randn(64, generator=g),
                        "running_mean": 0.1 * torch.randn(64, generator=g),
                        "running_var": 1.0 + torch.rand(64, generator=g),
                        "num_batches_tracked": torch.tensor(0)},
              "gy": torch.randn(16, 64, 9, 9, generator=g)}
    torch.save(inputs, tmp_path / "bn_cuda_in.pt")
    results = [res["bn"] for _, res in spawn("bn_cuda", str(tmp_path), world=2, timeout=300)]
    for name, gates in GATES.items():
        bn = BatchNorm(64)
        bn.load_state_dict(inputs["state"])
        bn.to(cuda).train()
        xc = inputs["x_" + name].to(cuda).requires_grad_(True)
        y = bn(xc)
        (y.float() * inputs["gy"].to(cuda)).sum().backward()
        want = {"y": y.float(), "x_grad": xc.grad.float(), "weight_grad": bn.weight.grad,
                "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
                "running_var": bn.running_var}
        per = [r[name] for r in results]
        got = {"y": torch.cat([p["y"] for p in per]),
               "x_grad": torch.cat([p["x_grad"] for p in per]),
               "weight_grad": per[0]["weight_grad"] + per[1]["weight_grad"],
               "bias_grad": per[0]["bias_grad"] + per[1]["bias_grad"],
               "running_mean": per[0]["running_mean"], "running_var": per[0]["running_var"]}
        assert torch.equal(per[0]["running_var"], per[1]["running_var"])
        for k, (rtol, atol, share) in gates.items():
            w = want[k].detach().float().cpu()
            torch.testing.assert_close(got[k].float(), w, rtol=rtol,
                                       atol=atol + share * float(w.abs().max()),
                                       msg=lambda m: f"{name} {k}: {m}")


@pytest.mark.parametrize("family", ["SNGAN_MNIST", "BigGAN", "StyleGAN2", "ProgGAN"])
def test_nccl_graphed_chunks_match_eager_steps(cuda, tmp_path, family):
    k, iters = 3, 9
    torch.save((family, k, iters), tmp_path / "graph_nccl_in.pt")
    (_, res), = spawn("graph_nccl", str(tmp_path), world=1, timeout=600,
                      extra_env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    assert res["captured"]
    got, rows = res["graphed"]
    want, want_rows = res["eager"]
    again, again_rows = res["again"]
    assert rows.shape == (iters, 4) and bool(torch.isfinite(rows).all())
    if _bit_equal(want, again):
        assert _bit_equal(got, want)
        assert torch.equal(rows, want_rows)
        return
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name.endswith(".step") or w.dtype == torch.long:
            assert torch.equal(got[name], w), name
        else:
            assert _close_as_eager(got[name], w, again[name]), (name, SPREAD)
    assert _close_as_eager(rows, want_rows, again_rows)


def _files(root):
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            with open(osp.join(dirpath, f), "rb") as fh:
                out[osp.relpath(osp.join(dirpath, f), root)] = fh.read()
    return out


def test_two_gloo_ranks_split_one_stylegan2_code(cuda, tmp_path, monkeypatch):
    from warpedganspace_torch.cli import sample_gan, traverse_latent_space
    from warpedganspace_torch.models.support_sets import SupportSets
    from warpedganspace_torch.ops import rbf_cuda, sg2_tail_cuda

    k, steps, batch = 3, 2, 4                   # 15 frames: 4 batches, the last padded
    G = _generator("StyleGAN2", torch.device("cpu"))[0]
    base = tmp_path / "base"
    base.mkdir()
    monkeypatch.chdir(base)
    monkeypatch.setattr(sample_gan, "build_gan", lambda **kw: G.to(kw["device"]))
    sample_gan.main(["-g", "StyleGAN2", "--num-samples", "1", "--pool", "one",
                     "--stylegan2-resolution", "256", "--shift-in-w-space"])
    os.makedirs(osp.join("exp", "models"))
    S = SupportSets(k, 8, 512, learn_gammas=True, generator=torch.Generator().manual_seed(3))
    torch.save(S.to_torch_state_dict(), osp.join("exp", "models", "support_sets.pt"))
    with open(osp.join("exp", "args.json"), "w") as f:
        json.dump({"gan_type": "StyleGAN2", "num_support_sets": k, "num_support_dipoles": 8,
                   "learn_alphas": False, "learn_gammas": True, "gamma": None,
                   "shift_in_w_space": True, "stylegan2_resolution": 256}, f)
    for name in ("single", "ranks/multi"):
        shutil.copytree(base, tmp_path / name)
    argv = ["--exp", "exp", "--pool", "one", "--shift-steps", str(steps), "--eps", "0.2",
            "--batch-size", str(batch), "--dtype", "bfloat16"]

    monkeypatch.chdir(tmp_path / "single")
    monkeypatch.setattr(traverse_latent_space, "build_gan", lambda **kw: G.to(kw["device"]))
    rbf_cuda.launches = sg2_tail_cuda.launches = 0
    traverse_latent_space.main(argv)
    torch.cuda.synchronize()
    single_launches = {"rbf_warp": rbf_cuda.launches, "sg2_tail": sg2_tail_cuda.launches}
    G.cpu()
    torch.save({"G": G, "argv": argv + ["--multi-device"], "backend": "gloo"},
               tmp_path / "ranks" / "traverse_in.pt")
    ranks = [res for _, res in spawn("traverse", str(tmp_path / "ranks"), world=2, timeout=600)]

    assert [[b for b in r["rendered"] if b[1] > b[0]] for r in ranks] == [[(0, 2)], [(2, 4)]]
    assert single_launches["rbf_warp"] == steps and single_launches["sg2_tail"] > 0
    per_batch = single_launches["sg2_tail"] // 4
    for r in ranks:
        assert r["launches"] == {"rbf_warp": steps, "sg2_tail": 2 * per_batch}, r["launches"]
    res = osp.join("exp", "results", "one", "4_0.2_0.8")
    single, multi = (_files(tmp_path / d / res) for d in ("single", "ranks/multi"))
    assert sorted(multi) == sorted(single)
    assert sum(f.endswith(".jpg") for f in single) == k * (2 * steps + 1) + 1
    for rel, data in single.items():
        assert multi[rel] == data, rel
