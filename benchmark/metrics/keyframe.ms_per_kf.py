"""keyframe.ms_per_kf: host ms in the program's ``1.KF_Processing`` label
over the window, per keyframe (its device waits included)."""


def read(run):
    t = run["timers"].get("1.KF_Processing")
    return t["total_ms"] / t["n"] if t and t["n"] else None
