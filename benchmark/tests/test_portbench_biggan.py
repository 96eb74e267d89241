"""BigGAN's counts and readers (``benchmark/families/biggan.py``,
``benchmark/counts/attention.py``, the ``attn_*`` and ``ccbn_*`` readers):
the frame's operations by hand at the tiny size, the attention's least time
at the cell's shape, and each reader on synthetic events; on the card
(``-m gpu``) the cell's kernel time put down to the port's spans and every
per-layer metric it lists read."""
import pytest
import torch

from benchmark import run as bench_run
from benchmark import spans as sp
from benchmark import trace as tr
from benchmark.counts import attention, generators
from benchmark.families import biggan
from benchmark.tests.portbench_tiny import bench, config
from benchmark.trace import Event

CFG = config("biggan128-239-z")
T = 7  # the host thread


def test_frame_count_by_hand_at_the_tiny_size():
    """32x32, 32 channels throughout, three blocks, the attention at 32x32:
    chunks of 120 // 4 = 30, conditions of 128 + 30."""
    cfg = dict(CFG, **biggan.TINY)
    c, cond = 32, 158
    want = 2 * 30 * c * 16                                    # the first linear, 4x4 map
    for r in (8, 16, 32):
        want += 4 * 2 * cond * c                              # bn1, bn2: gain and bias
        want += 2 * r * r * 4 * c * c                         # up-conv, 4 merged taps
        want += 2 * r * r * 9 * c * c                         # conv2
        want += 2 * (r // 2) ** 2 * c * c                     # the shortcut, low resolution
    n, m, dk, dv = 32 * 32, 16 * 16, 4, 16
    want += 2 * n * c * dk * 2 + 2 * n * c * dv + 2 * n * dv * c   # theta, phi, g, o
    want += 2 * n * m * (dk + dv)                             # logits, values
    want += 2 * 32 * 32 * 9 * c * 3                          # the output conv
    assert generators.frame_flops(cfg) == want
    assert biggan.attention_shape(cfg) == (n, m, dk, dv)


def test_the_configurations_count_is_pinned():
    """26.6 GFLOP a frame at 128x128 (24.5 of it the 3x3 convolutions, 1.0 the
    attention's two products), summed by hand block by block."""
    assert generators.frame_flops(CFG) == 26_615_072_256
    assert biggan.blocks(CFG) == [(1536, 1536, 8, False), (1536, 768, 16, False),
                                  (768, 384, 32, False), (384, 192, 64, True),
                                  (192, 96, 128, False)]
    assert biggan.attention_shape(CFG) == (4096, 1024, 24, 96)


def test_the_attention_bound_at_the_cell_shape():
    """B=64, N=4096, M=1024, dk=24, dv=96 in bf16: the 268 M exponentials
    (0.0695 ms) over the products (0.0651 ms) and the bytes (0.0235 ms)."""
    b, (n, m, dk, dv) = 64, biggan.attention_shape(CFG)
    assert round(attention.forward_ms(b, n, m, dk, dv, elem=2), 4) == 0.0695
    assert attention.forward_ms(b, n, m, dk, dv, elem=2) == pytest.approx(
        1e3 * b * n * m / attention.PEAK_EXP_PER_S)
    assert attention.forward_ms(b, n, m, dk, dv, elem=4) == pytest.approx(
        1e3 * 2 * b * n * m * (dk + dv) / 495e12)


DEMANGLED = "void tc::sa_attention_tc_kernel<2, 12>(__nv_bfloat16 const*, __nv_bfloat16 const*)"
MANGLED = "_ZN2tc22sa_attention_tc_kernelILi2ELi12EEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiiiiii"


def events(kernel=DEMANGLED, program=True) -> list:
    """A window of 3 ms: one render batch whose generator launches a ccbn
    kernel, the attention kernel (1 ms) inside the attention block's span,
    and a kernel outside both spans."""
    ms = 1_000_000
    ev = [
        Event("bench.window", 0, 3 * ms, False, T, 1),
        Event("wgs.render.generator", 10, 2 * ms, False, T, 2),
        Event("wgs.biggan.ccbn", 20, 100, False, T, 3),
        Event("wgs.biggan.attention", 200, 400, False, T, 4),
        Event("cudaLaunchKernel", 30, 40, False, T, 101),
        Event("cudaLaunchKernel", 300, 310, False, T, 102),
        Event("cudaLaunchKernel", 500, 510, False, T, 103),
        Event("ccbn_kernel", 1000, 1000 + ms // 4, True, 0, 101),
        Event(kernel, ms, 2 * ms, True, 0, 102),
        Event("conv_kernel", 2 * ms, 2 * ms + ms // 2, True, 0, 103),
    ]
    return [e for e in ev if program or not e.name.startswith("wgs.")]


def view(evs, frames=64, cfg=CFG, dtype="bfloat16"):
    return bench_run.View(traces=[tr.from_events(evs)], work={"frames": frames}, config=cfg,
                          params={"batch": 64, "dtype": dtype})


@pytest.mark.parametrize("kernel", [DEMANGLED, MANGLED], ids=["demangled", "mangled"])
def test_the_attention_roofline_reads_the_kernel_by_either_name(kernel):
    read = bench_run.reader("attn_roofline.render").read
    want = 100.0 * attention.forward_ms(64, 4096, 1024, 24, 96, elem=2) / 1.0
    assert read(view(events(kernel))) == pytest.approx(want)
    assert read(view(events("void tc::sa_attention_tf_kernel<2, 12>(float const*)"))) is None
    assert read(view(events(kernel), dtype="float32")) is None
    assert read(view(events(kernel), cfg=config("proggan-celebahq1024-z"))) is None


def test_the_span_readers_read_their_spans():
    attn = bench_run.reader("attn_ms_per_frame.render").read
    ccbn = bench_run.reader("ccbn_ms_per_frame.render").read
    assert attn(view(events())) == pytest.approx(1.0 / 64)
    assert ccbn(view(events())) == pytest.approx(0.25 / 64)
    both = bench_run.View(traces=[tr.from_events(events())] * 2, work={"frames": 128},
                          config=CFG, params={})
    assert attn(both) == pytest.approx(1.0 / 64)
    for read in (attn, ccbn):
        assert read(view(events(program=False))) is None
        assert read(view(events(), frames=0)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_the_cells_device_time_is_put_down_to_its_spans(card):
    """A 2 s traced window of the BigGAN cell: 99 % of the kernel and copy
    time launched inside some wgs.* span, the attention block's and the
    ccbn's inside the generator's, and each per-layer metric the cell lists
    read above 0, the attention kernel's roofline share under 100 %."""
    run = bench_run.make_run("biggan128-render-bf16", 2 ** 33 + 307, 2.0, True, card)
    raw, out = sp.trace_window(run)
    t = tr.from_events(raw)
    frames = out["work"]["frames"]
    assert sp.quantities(t, frames)["attributed_pct"] >= 99.0, sp.report(t, frames)
    generator = t.launched_s(("wgs.render.generator",), copies=False)
    blocks = t.launched_s(("wgs.biggan.attention", "wgs.biggan.ccbn"), copies=False)
    assert 0 < blocks < generator
    view = bench_run.View(traces=[t], work=out["work"], config=run.config, params=run.params)
    _, per_layer = bench_run.cell_metrics(bench(), "biggan128-render-bf16")
    values = {m["name"]: bench_run.reader(m["name"]).read(view) for m in per_layer}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["attn_roofline.render"] < 100.0
