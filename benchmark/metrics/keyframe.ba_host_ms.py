"""keyframe.ba_host_ms: host ms of the local BA's own host work over the
window, the problem's build from the map (``1.BA_build``) and the
write-back of the result (``1.BA_writeback``), per problem built."""


def read(run):
    b = run["timers"].get("1.BA_build")
    if not b or not b["n"]:
        return None
    w = run["timers"].get("1.BA_writeback")
    return (b["total_ms"] + (w["total_ms"] if w else 0.0)) / b["n"]
