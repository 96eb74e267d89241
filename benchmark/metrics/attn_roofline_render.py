"""attn_roofline.render: the bf16 attention forward kernel
(``csrc/sa_attention.cu``, ``tc::sa_attention_tc_kernel<KS, NV>``) at its
least time (``benchmark/counts/attention.py``), summed over its launches in
the traced render window, over its profiled time. Every launch is one render
batch's attention block at the configuration's shape."""
from benchmark.counts.attention import forward_ms
from benchmark.trace import roofline_share

# Demangled, and mangled as ``sa_attention_tc_kernel<int KS, int NV>``; KS,
# the k16 steps of dk, is the group read.
PATTERNS = (r"sa_attention_tc_kernel<(\d+), \d+>", r"22sa_attention_tc_kernelILi(\d+)ELi\d+EE")


def read(view):
    if view.config["family"] != "biggan" or view.params["dtype"] != "bfloat16":
        return None
    from benchmark.families.biggan import attention_shape

    n, m, dk, dv = attention_shape(view.config)
    shape = (view.params["batch"], n, m, dk, dv)
    return roofline_share(view, PATTERNS, {(dk + 15) // 16: shape},
                          lambda s: forward_ms(*s, elem=2))
