"""ccbn_ms_per_frame.render: the kernel time launched inside the port's
``wgs.biggan.ccbn`` spans (each class-conditional batch norm: its two
linears, the normalisation, gain and bias) in the traced render window, per
frame delivered."""
from benchmark.metrics.attn_ms_per_frame_render import span_ms_per_frame


def read(view):
    return span_ms_per_frame(view, "wgs.biggan.ccbn")
