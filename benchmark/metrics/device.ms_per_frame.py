"""device.ms_per_frame: the card's busy time (the union of its kernels,
copies and memsets) in the traced window, per frame traced."""


def read(run):
    t = run.get("trace")
    if not t or not t.get("frames"):
        return None
    return 1e3 * t["busy_s"] / t["frames"]
