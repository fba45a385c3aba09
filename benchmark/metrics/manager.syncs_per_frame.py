"""manager.syncs_per_frame: host synchronisations with the card over the
window (PyTorch's sync debug mode, one warning each), per frame."""


def read(run):
    if run.get("syncs") is None or not run["frames"]:
        return None
    return run["syncs"] / run["frames"]
