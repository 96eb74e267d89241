"""train_mfu: the samples completed in the traced window times the step's
operations per sample (two generator forwards, the shift's data gradient
through the generator, the warp, the reconstructor's forward and backward;
from the configuration's shapes at their least arithmetic, recomputation not
counted), over the window and the cards' dense bf16 peak."""
from benchmark.counts.peaks import PEAK_BF16_FLOPS
from benchmark.counts.step import step_flops_per_sample


def read(view):
    samples = view.work.get("samples")
    if not samples:
        return None
    window_s = max(t.window_s for t in view.traces)
    return 100.0 * samples * step_flops_per_sample(view.config)["total"] / window_s / (
        len(view.traces) * PEAK_BF16_FLOPS)
