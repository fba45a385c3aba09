"""frontend.gate_open_pct: the share of the window's frames whose parallax
gate opened, so that the epipolar filter's graph replayed: the count of
the program's ``0.FE_graph_filter`` spans over that of ``0.FE_graph_front``
(one a frame), in percent. A descriptive counter of the workload, not a
target: a change that reads lower by skipping the filter is no gain (the
schema asks for a direction; this one has none)."""


def read(run):
    front = run["timers"].get("0.FE_graph_front")
    if front is None or not front["n"]:
        return None
    filt = run["timers"].get("0.FE_graph_filter")
    return 100.0 * (filt["n"] if filt else 0) / front["n"]
