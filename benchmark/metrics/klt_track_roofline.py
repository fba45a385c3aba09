"""klt_track_roofline: over a sample of the traced window's tracking
calls (each chunk's first), the least time their inputs need
(``kltbound.klt_bound``: bytes over 3.35 TB/s or float32 operations over
67 TFLOP/s, the larger) over their ``klt_track`` kernel time in the device
trace, in percent. Nothing where the trace's klt_track kernels do not
line up one to one with the calls made."""


def read(run):
    k = run.get("klt")
    if (not k or k["found"] != k["expected"] or not k["kernel_ms"]
            or len(k["kernel_ms"]) != len(k["bound_ms"])):
        return None
    return 100.0 * sum(k["bound_ms"]) / sum(k["kernel_ms"])
