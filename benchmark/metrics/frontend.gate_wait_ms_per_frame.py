"""frontend.gate_wait_ms_per_frame: host ms in the program's
``0.FE_gate_read`` label (the host's read of the parallax gate between a
frame's graph replays: a wait on the card) over the window, per frame."""


def read(run):
    t = run["timers"].get("0.FE_gate_read")
    if t is None or not run["frames"]:
        return None
    return t["total_ms"] / run["frames"]
