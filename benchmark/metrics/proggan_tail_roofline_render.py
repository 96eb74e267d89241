"""proggan_tail_roofline.render: the ProgGAN tail kernel
(``csrc/proggan_tail.cu``, template arguments C and HEAD) at its least time,
summed over its launches in the traced render window, over its profiled time."""
from benchmark.counts.generators import proggan_tail_sections
from benchmark.counts.tails import proggan_section_ms
from benchmark.trace import roofline_share

# Demangled, and mangled as ``section_kernel<int C, bool HEAD>``.
PATTERNS = (r"section_kernel<(\d+), (?:true|false)>", r"14section_kernelILi(\d+)ELb[01]EEv")


def read(view):
    if view.config["family"] != "proggan":
        return None
    elem = 2 if view.params["dtype"] == "bfloat16" else 4
    sections = {c: (b, c, h, w, head)
                for b, c, h, w, head in proggan_tail_sections(view.config, view.params["batch"])}
    return roofline_share(view, PATTERNS, sections,
                 lambda shape: proggan_section_ms(*shape, elem=elem))
