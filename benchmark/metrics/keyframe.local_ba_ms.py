"""keyframe.local_ba_ms: host ms in the program's ``1.BA_localBA`` label
over the window, per local BA solve."""


def read(run):
    t = run["timers"].get("1.BA_localBA")
    return t["total_ms"] / t["n"] if t and t["n"] else None
