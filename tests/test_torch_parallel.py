"""The port's data parallelism over ``torch.distributed``, on two gloo ranks
on the CPU, against the port in one process and against the JAX package.

One spawn of two ranks (``tests/torch_ranks.py``, scenario ``units``) runs
every multi-process case, and the tests below read what each rank saved:

- R's BatchNorm with ``sync_moments``, each rank with half the batch, against
  the port's BatchNorm on the whole batch and JAX's
  ``nn.batch_norm(..., axis_name=)`` under ``shard_map`` on two of the
  conftest's virtual devices: outputs, running statistics, input and weight
  gradients, in f32 and with bf16 input; and without the flag, where the
  ranks' moments are their own and the output is not the global one;
- one and two data-parallel steps of SNGAN-MNIST (small) and LeNet (which has
  BatchNorm), the weights made by the JAX package and carried over by
  ``convert/from_jax.py``, the global batches injected on both sides, against
  JAX's ``make_train_step(..., mesh=make_mesh(jax.devices()[:2]))``; and a
  recorder on ``torch.distributed.all_reduce`` in the first step: the S and R
  gradients (one flat buffer), each BatchNorm's moments forward and
  backward, the metric row, and nothing else;
- BigGAN with two target classes: each rank conditions its rows on the
  classes the global batch draws, and the step equals the one-process step;
- ``assert_identical_across_processes`` passing on equal trees and raising on
  both ranks when one rank's tree differs.

``partition_work`` is held to the JAX package's in this process.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.test_torch_train_step import _batch, _jax_r_grads, _setup_pair
from tests.torch_ranks import spawn
from warpedganspace_tpu.convert import lenet_reconstructor_to_state_dict
from warpedganspace_tpu.nn import core as jnn
from warpedganspace_tpu.parallel import make_mesh
from warpedganspace_tpu.parallel import partition_work as j_partition_work
from warpedganspace_tpu.train import train_step as j_train_step
from warpedganspace_torch.models.api import GeneratorBundle
from warpedganspace_torch.models.biggan import BigGANGenerator
from warpedganspace_torch.models.reconstructor import BatchNorm, Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.parallel import partition_work
from warpedganspace_torch.train.train_step import TrainStepConfig, init_train_state, train_step

torch.set_num_threads(1)

WORLD, B, K = 2, 8, 4
STEP_CFG = dict(batch_size=B, num_support_sets=K, min_shift_magnitude=0.1,
                max_shift_magnitude=0.2)
LENET_BN = (6, 16, 120, 84, 84)          # LeNet (width 2): three conv BNs, two head BNs
LR = 1e-4


def _bn_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, 6, 5, 5, generator=g) * 2.0 + 1.0
    state = {"weight": 1.0 + 0.5 * torch.rand(6, generator=g),
             "bias": 0.3 * torch.randn(6, generator=g),
             "running_mean": 0.1 * torch.randn(6, generator=g),
             "running_var": 1.0 + torch.rand(6, generator=g),
             "num_batches_tracked": torch.tensor(0)}
    return {"x_f32": x, "x_bf16": x.bfloat16(), "state": state,
            "gy": torch.randn(B, 6, 5, 5, generator=g)}


def _biggan_inputs():
    gen = BigGANGenerator(resolution=32, ch=16, shared_dim=16, n_classes=1000,
                          attention="32", target_classes=(238, 239),
                          generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.7)
    G = GeneratorBundle("BigGAN", gen.requires_grad_(False).eval(), dim_z=120, resolution=32)
    init = torch.Generator().manual_seed(13)
    S = SupportSets(K, 3, 120, learn_gammas=True, generator=init)
    R = Reconstructor("LeNet", dim=K, channels=3, generator=init)
    z, idx, mags = _batch(21, b=B, dim_z=120)
    batch = (torch.from_numpy(z), torch.from_numpy(idx).long(), torch.from_numpy(mags))
    return {"G": G, "S": S, "R": R, "cfg": STEP_CFG, "batches": [batch]}


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """(inputs, each rank's results, the JAX side of the SNGAN steps)."""
    from tests.test_torch_sngan import small_sngan_bundles

    jG, G = small_sngan_bundles(seed=1)
    jax_side, state = _setup_pair(jG, G, "LeNet", 1, 128, batch_size=B)
    batches = [_batch(s, b=B, dim_z=128) for s in (4, 5)]
    inputs = {
        "bn": _bn_inputs(),
        "sngan": {"G": G, "S": copy.deepcopy(state.S), "R": copy.deepcopy(state.R),
                  "cfg": STEP_CFG,
                  "batches": [(torch.from_numpy(z), torch.from_numpy(i).long(),
                               torch.from_numpy(m)) for z, i, m in batches]},
        "biggan": _biggan_inputs(),
    }
    workdir = tmp_path_factory.mktemp("units")
    torch.save(inputs, workdir / "units_in.pt")
    results = [res for _, res in spawn("units", str(workdir), world=WORLD, timeout=300)]
    return inputs, results, (jax_side, batches)


# -------------------------------------------------------------------- SyncBN
def _port_bn(inputs, name):
    bn = BatchNorm(6)
    bn.load_state_dict(inputs["state"])
    bn.train()
    x = inputs["x_" + name].clone().requires_grad_(True)
    y = bn(x)
    (y.float() * inputs["gy"]).sum().backward()
    return {"y": y.detach().float(), "x_grad": x.grad.float(), "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def _jax_bn(inputs, name):
    mesh = make_mesh(jax.devices()[:WORLD])
    st = inputs["state"]
    params = {"scale": jnp.asarray(st["weight"].numpy()), "bias": jnp.asarray(st["bias"].numpy()),
              "mean": jnp.asarray(st["running_mean"].numpy()),
              "var": jnp.asarray(st["running_var"].numpy())}
    dtype = jnp.bfloat16 if name == "bf16" else jnp.float32
    x = jnp.asarray(inputs["x_f32"].numpy().transpose(0, 2, 3, 1)).astype(dtype)
    gy = jnp.asarray(inputs["gy"].numpy().transpose(0, 2, 3, 1))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P("data")),
                       out_specs=(P("data"), P()))
    def sync_bn(p, xs):
        return jnn.batch_norm(p, xs, train=True, axis_name="data")

    def loss(p, xs):
        y, _ = sync_bn(p, xs)
        return jnp.sum(y.astype(jnp.float32) * gy)

    y, new = jax.jit(sync_bn)(params, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    to_nchw = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32)).transpose(0, 3, 1, 2))
    return {"y": to_nchw(y), "x_grad": to_nchw(gx),
            "weight_grad": torch.from_numpy(np.array(gp["scale"])),
            "bias_grad": torch.from_numpy(np.array(gp["bias"])),
            "running_mean": torch.from_numpy(np.array(new["mean"])),
            "running_var": torch.from_numpy(np.array(new["var"]))}


def _ranks_bn(results, key, name):
    """The two ranks' BatchNorm seen as one: rows joined, parameter
    gradients summed (the loss is the sum over the global batch), the running
    statistics rank 0's (each rank must hold the same)."""
    per = [res[key][name] for res in results]
    for k in ("running_mean", "running_var"):
        assert torch.equal(per[0][k], per[1][k]), k
    return {"y": torch.cat([p["y"] for p in per]), "x_grad": torch.cat([p["x_grad"] for p in per]),
            "weight_grad": per[0]["weight_grad"] + per[1]["weight_grad"],
            "bias_grad": per[0]["bias_grad"] + per[1]["bias_grad"],
            "running_mean": per[0]["running_mean"], "running_var": per[0]["running_var"]}


# The gates by reference. f32: 1e-5 throughout. With bf16 input the
# statistics stay f32 sums (1e-5); y and the input gradient are bf16 tensors
# formed from the f32 moments, where an element may round to its neighbour
# when the moments differ in their last bits: one bfloat16 step, which is at
# most 2**-7 of the element and so of the largest magnitude. The parameter
# gradients sum bf16 products, on each rank and then over the ranks: two
# roundings, 2**-6. JAX squares the bf16 input before its f32 mean (the port
# squares in f32), so its running variance is held to 2**-7 relative, and XLA
# sums the bf16 products of the parameter gradients in bf16: those are held
# to the port's one-process BatchNorm only.
_BF16 = 2 ** -7
_F32 = (0.0, 1e-5, 0.0)                  # (rtol, atol, atol as a share of the largest magnitude)
BN_GATES = {
    ("f32", "one process"): {k: _F32 for k in (
        "y", "x_grad", "weight_grad", "bias_grad", "running_mean", "running_var")},
    ("bf16", "one process"): {"y": (0.0, 0.0, _BF16), "x_grad": (0.0, 0.0, _BF16),
                              "weight_grad": (0.0, 0.0, 2 * _BF16),
                              "bias_grad": (0.0, 0.0, 2 * _BF16),
                              "running_mean": _F32, "running_var": _F32},
    ("bf16", "JAX axis_name"): {"y": (0.0, 0.0, _BF16), "x_grad": (0.0, 0.0, _BF16),
                                "running_mean": _F32, "running_var": (_BF16, 1e-5, 0.0)},
}
BN_GATES[("f32", "JAX axis_name")] = BN_GATES[("f32", "one process")]


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sync_bn_is_the_global_batch_norm(units, name):
    inputs, results, _ = units
    got = _ranks_bn(results, "bn", name)
    for ref_name, ref in (("one process", _port_bn(inputs["bn"], name)),
                          ("JAX axis_name", _jax_bn(inputs["bn"], name))):
        for k, (rtol, atol, share) in BN_GATES[(name, ref_name)].items():
            want = ref[k].float().numpy()
            np.testing.assert_allclose(got[k].numpy(), want, rtol=rtol,
                                       atol=atol + share * float(np.abs(want).max()),
                                       err_msg=f"{name} {k} vs {ref_name}")


def test_local_bn_differs_from_sync_bn(units):
    """Sanity: without ``sync_moments`` each rank normalises by its own
    moments, which are not the global batch's."""
    inputs, results, _ = units
    local = torch.cat([res["bn_local"]["f32"]["y"] for res in results])
    ref = _port_bn(inputs["bn"], "f32")
    assert float((local - ref["y"]).abs().max()) > 0.1
    assert not torch.equal(results[0]["bn_local"]["f32"]["running_mean"],
                           results[1]["bn_local"]["f32"]["running_mean"])


# ------------------------------------------------------------- the DP steps
def _jax_steps(jax_side, batches, monkeypatch):
    """JAX's step on a two-device mesh from the same state, once per batch."""
    jG, JS, JR, jcfg, jstate = jax_side
    mesh = make_mesh(jax.devices()[:WORLD])
    out = []
    for z, idx, mags in batches:
        arrays = tuple(jnp.asarray(a) for a in (z, idx, mags))
        monkeypatch.setattr(j_train_step, "sample_batch_directives", lambda *a, **kw: arrays)
        step = j_train_step.make_train_step(jG, JS, JR, jcfg, mesh=mesh, donate=False)
        jstate, jmetrics = step(jstate, jG.params, jax.random.key(0), 1)
        out.append((jstate, jmetrics))
    return out


@pytest.mark.parametrize("n_steps", [1, 2])
def test_data_parallel_steps_match_jax_mesh_step(units, n_steps, monkeypatch):
    """After ``n_steps`` steps both ranks hold the same S, R and statistics,
    and these are JAX's after its mesh steps: within 1e-5, but for the R
    leaves whose gradient is zero but for rounding in JAX's first step (the
    biases in front of a BatchNorm), where Adam's first steps take either
    sign and are held to 2 * lr a step (``tests/test_torch_train_step.py``'s
    rule), and the running means those biases feed in later steps."""
    inputs, results, (jax_side, batches) = units
    jsteps = _jax_steps(jax_side, batches[:n_steps], monkeypatch)
    jnew, jmetrics = jsteps[-1]
    steps = [res["sngan"]["steps"][n_steps - 1] for res in results]
    for k in ("S", "R"):
        for name, v in steps[0][k].items():
            assert torch.equal(v, steps[1][k][name]), (k, name)
    assert steps[0]["metrics"] == steps[1]["metrics"]
    got = steps[0]
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, float(jmetrics[k]), rtol=0, atol=1e-5, err_msg=k)
    js = jax.tree_util.tree_map(np.asarray, jnew["s_params"])
    for k in ("support_sets", "loggamma", "alphas"):
        np.testing.assert_allclose(got["S"][k].numpy(), js[k], rtol=0, atol=1e-5, err_msg=k)
    jgrad = lenet_reconstructor_to_state_dict(_jax_r_grads(jsteps[0][0]))
    tiny = 1e-4 * max(float(np.abs(g).max()) for g in jgrad.values())
    want = lenet_reconstructor_to_state_dict(jax.tree_util.tree_map(np.asarray, jnew["r_params"]))
    trained = {n for n, _ in inputs["sngan"]["R"].named_parameters()}
    rounding_only = [n for n in sorted(trained) if float(np.abs(jgrad[n]).max()) <= tiny]
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        atol = 1e-5
        if name in rounding_only:
            atol += n_steps * 2 * LR
        elif name.endswith("running_mean"):
            # A later step's mean reads the bias in front after the earlier
            # steps, each within 2 * lr, at the running average's momentum 0.1.
            head, index, _ = name.rsplit(".", 2)
            if f"{head}.{int(index) - 1}.bias" in rounding_only:
                atol += 0.1 * (n_steps - 1) * 2 * LR
        np.testing.assert_allclose(got["R"][name].numpy(), ref, rtol=0, atol=atol, err_msg=name)
    assert len(rounding_only) == 5, rounding_only
    assert float(got["R"]["feature_extractor.1.running_mean"].abs().max()) > 0


def test_one_step_reduces_only_s_and_r(units):
    """The first step's all-reduces: one flat buffer of every S and R
    gradient element, each BatchNorm's two moments forward and their
    cotangents backward, and the 4 metrics; no tensor of G."""
    inputs, results, _ = units
    S, R = inputs["sngan"]["S"], inputs["sngan"]["R"]
    n_sr = sum(p.numel() for p in S.parameters() if p.requires_grad) \
        + sum(p.numel() for p in R.parameters())
    want = sorted([(n_sr,), (4,)] + [(2, c) for c in LENET_BN] * 2)
    for res in results:
        assert sorted(res["sngan"]["steps"][0]["all_reduce"]) == want


def test_biggan_two_classes_draw_the_global_batchs_classes(units):
    """With classes (238, 239) each rank conditions its rows on the classes
    the global z draws (a draw on its own rows would read other bits), and the
    two-rank step equals the one-process step on the global batch."""
    inputs, results, _ = units
    bg = inputs["biggan"]
    z = bg["batches"][0][0]
    want = bg["G"].net.mixed_classes(z)
    assert set(want.tolist()) == {238, 239}
    local_draws = []
    for r, res in enumerate(results):
        rows = slice(r * B // WORLD, (r + 1) * B // WORLD)
        seen = res["biggan"]["classes"]
        assert len(seen) == 2                    # G(z) and G(z + shift), one step
        for y in seen:
            assert torch.equal(y, want[rows])
        local_draws.append(bg["G"].net.mixed_classes(z[rows]))
    assert not torch.equal(torch.cat(local_draws), want)

    state = init_train_state(bg["G"], copy.deepcopy(bg["S"]), copy.deepcopy(bg["R"]),
                             TrainStepConfig(**bg["cfg"]))
    metrics = train_step(state, 1, batch=bg["batches"][0])
    got = results[0]["biggan"]["steps"][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=0, atol=1e-5, err_msg=k)
    # Adam's step is sensitive where a gradient is near its eps (1e-8): an
    # element whose gradient is below 1e-4 of the largest is held to 2 * lr.
    grad = state.S.support_sets.grad.abs()
    rounding = grad <= 1e-4 * float(grad.max())
    diff = (got["S"]["support_sets"] - state.S.support_sets.detach()).abs()
    assert float(diff[~rounding].max()) <= 1e-5
    assert float(diff.max()) <= 2 * LR + 1e-5
    np.testing.assert_allclose(got["S"]["loggamma"].numpy(), state.S.loggamma.detach().numpy(),
                               rtol=0, atol=1e-5)


def test_identity_check_raises_on_every_rank(units):
    _, results, _ = units
    for res in results:
        assert res["differs"] is not None and "rank(s) [1]" in res["differs"]


@pytest.mark.parametrize("n, shards", [(0, 1), (5, 1), (5, 2), (7, 3), (2, 4), (9, 9)])
def test_partition_work_equals_jax(n, shards):
    items = [f"{i:04x}" for i in range(n)]
    parts = [partition_work(items, shards, i) for i in range(shards)]
    assert parts == [j_partition_work(items, shards, i) for i in range(shards)]
    assert sorted(sum(parts, [])) == items
    for bad in (-1, shards):
        with pytest.raises(ValueError):
            partition_work(items, shards, bad)
