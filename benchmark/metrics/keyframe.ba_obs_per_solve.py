"""keyframe.ba_obs_per_solve: observations per BA problem built in the
window, from the program's ``1.BA_nobs`` samples (one per problem; a
sampled label's ``total_ms`` holds the sum of its samples). A descriptive
counter of the local BA's problem size, not a target: a change that reads
lower by shrinking the BA window is no gain (the schema asks for a
direction; this one has none)."""


def read(run):
    t = run["timers"].get("1.BA_nobs")
    return t["total_ms"] / t["n"] if t and t["n"] else None
