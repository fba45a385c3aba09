"""manager.kf_per_100_frames: keyframes created in the window (the
trajectory logger's flags) per 100 frames: which layer the traffic loads."""


def read(run):
    return 100.0 * run["keyframes"] / run["frames"] if run["frames"] else None
