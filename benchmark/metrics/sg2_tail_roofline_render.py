"""sg2_tail_roofline.render: the StyleGAN2 tail kernel (``csrc/sg2_tail.cu``,
one template argument C) at its least time, summed over its launches in the
traced render window, over its profiled time."""
from benchmark.counts.generators import sg2_tail_sections
from benchmark.counts.tails import sg2_section_ms
from benchmark.trace import roofline_share

# Demangled, and mangled as ``section_kernel<int C>``.
PATTERNS = (r"section_kernel<(\d+)>", r"14section_kernelILi(\d+)EEv")


def read(view):
    if view.config["family"] != "stylegan2":
        return None
    elem = 2 if view.params["dtype"] == "bfloat16" else 4
    sections = {c: (b, c, h, w, x2)
                for b, c, h, w, x2 in sg2_tail_sections(view.config, view.params["batch"])}
    return roofline_share(view, PATTERNS, sections,
                 lambda shape: sg2_section_ms(*shape, elem=elem))
