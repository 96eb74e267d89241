"""attn_ms_per_frame.render: the kernel time launched inside the port's
``wgs.biggan.attention`` spans (the SA-GAN block: its projections, pools,
transposes, the attention kernel, the output conv and the residual) in the
traced render window, per frame delivered."""

SPAN = "wgs.biggan.attention"


def span_ms_per_frame(view, span: str):
    """Kernel time launched inside ``span`` per delivered frame, the mean
    over the cards used (each its share of the frames); None without frames
    or where a card's window holds no such span."""
    frames = view.work.get("frames")
    if not frames:
        return None
    per_card = frames / len(view.traces)
    values = []
    for t in view.traces:
        if not any(n == span for _, _, n in t.clipped(t.program_spans)):
            return None
        values.append(1e3 * t.launched_s((span,), copies=False) / per_card)
    return sum(values) / len(values)


def read(view):
    return span_ms_per_frame(view, SPAN)
