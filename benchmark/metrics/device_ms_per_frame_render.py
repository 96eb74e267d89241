"""device_ms_per_frame.render: the kernel time summed over the traced render
window, per frame delivered, as the mean over the cards used."""


def read(view):
    frames = view.work.get("frames")
    if not frames:
        return None
    per_card = frames / len(view.traces)
    return sum(1e3 * t.kernel_s() / per_card for t in view.traces) / len(view.traces)
