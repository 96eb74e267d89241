"""device_idle_pct.train: the share of the traced training window in which a
card ran no kernel and no copy, as the mean over the ranks."""


def read(view):
    if "samples" not in view.work:
        return None
    return sum(100.0 * (1.0 - t.busy_s() / t.window_s) for t in view.traces) / len(view.traces)
