"""``python -m ov2slam_tpu_torch.run ... --chunk 4`` against the JAX
package's CLI with ``--chunk 4``, on ``test_torch_run.py``'s 12-frame EuRoC
tree, both as subprocesses on the CPU: frames 0-3 go frame by frame (the
map is initialized on frame 0 of the first chunk), frames 4-11 in two
chunks. Every frame has a finite trajectory row, and the ATEs lie within
``test_torch_run.py``'s bounds (1 mm, and a quarter of the JAX CLI's ATE
plus 0.1 mm).
"""

import numpy as np

import torch_parity  # noqa: F401  (caps torch threads)
from test_torch_run import (ATE_FLOOR, ATE_REL, ATE_TOL, N, _ate, _cli,  # noqa: F401
                            dataset)


def test_cli_chunk_matches_jax(dataset):
    root, gt = dataset
    ates = {}
    for name, module, extra in (("jax", "ov2slam_tpu.run", ["--no-cache"]),
                                ("torch", "ov2slam_tpu_torch.run",
                                 ["--device", "cpu"])):
        out = root / f"out_chunk_{name}"
        res = _cli(module, root, out, "--chunk", "4", *extra)
        assert res.returncode == 0, res.stderr[-3000:]
        assert f"processed {N} frames" in res.stdout
        rows = np.loadtxt(out / "ov2slam_traj.txt", ndmin=2)
        assert rows.shape == (N, 8) and np.isfinite(rows).all()
        ates[name] = _ate(out / "ov2slam_traj.txt", gt)
    gap = abs(ates["torch"] - ates["jax"])
    assert gap <= ATE_TOL and gap <= ATE_REL * ates["jax"] + ATE_FLOOR, ates
