"""setup_s: process start to the submission of the window's first chunk
(host clock): imports, the program's library builds or loads, rendering
the frames, building the system, and the warm-up frames."""


def read(run):
    return run["setup_s"]
