"""render_mfu: the frames delivered in the traced window times the
generator's operations per frame (counted from the configuration's shapes at
their least arithmetic), over the window and the card's dense bf16 peak."""
from benchmark.counts.generators import frame_flops
from benchmark.counts.peaks import PEAK_BF16_FLOPS


def read(view):
    frames = view.work.get("frames")
    if not frames:
        return None
    window_s = max(t.window_s for t in view.traces)
    return 100.0 * frames * frame_flops(view.config) / window_s / (
        len(view.traces) * PEAK_BF16_FLOPS)
