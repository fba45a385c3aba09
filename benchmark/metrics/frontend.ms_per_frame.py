"""frontend.ms_per_frame: host ms in the program's ``0.Full-Front_End``
label over the window (each chunk's tracking, its stats read included),
per frame."""


def read(run):
    t = run["timers"].get("0.Full-Front_End")
    if t is None or not run["frames"]:
        return None
    return t["total_ms"] / run["frames"]
