"""fps: frames whose pose the program returned in the measured window,
over the window's wall time (host clock; the window ends on a device
synchronise)."""


def read(run):
    return run["frames"] / run["window_s"] if run["window_s"] > 0 else None
