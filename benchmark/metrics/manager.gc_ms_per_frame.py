"""manager.gc_ms_per_frame: host ms in Python's garbage collections over
the window (the program's ``9.Host_GC`` label, a ``gc.callbacks`` hook
while its timers are on), per frame; 0.0 when none ran. Nothing where the
program has no such hook."""


def read(run):
    from ov2slam_tpu_torch.io import profiler
    label = getattr(profiler, "GC_LABEL", None)
    if label is None or not run["frames"]:
        return None
    t = run["timers"].get(label)
    return t["total_ms"] / run["frames"] if t else 0.0
