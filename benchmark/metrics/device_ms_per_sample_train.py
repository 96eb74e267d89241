"""device_ms_per_sample.train: the kernel time summed over the traced
training window, per sample of a rank's share of the global batch, as the
mean over the ranks."""


def read(view):
    samples = view.work.get("samples")
    if not samples:
        return None
    per_rank = samples / len(view.traces)
    return sum(1e3 * t.kernel_s() / per_rank for t in view.traces) / len(view.traces)
