"""The 24 shipped presets (parameters_files/*/*/*.yaml) through the port's
PyYAML-free loader against the JAX package's PyYAML loader, and that each
of them builds a port SlamSystem unchanged.

The loaders must give the same dict, key by key, with the same Python types
and float64 matrices; ``SlamParams.from_yaml`` the same value in every
field. Every preset builds a system on the CPU as shipped; the 12 with
``buse_loop_closer`` get a loop closer with the native place index.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.config import load_opencv_yaml as j_load
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.config import load_opencv_yaml
from ov2slam_tpu_torch.slam.manager import SlamSystem

import torch_parity  # noqa: F401  (caps torch threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(os.path.relpath(f, ROOT) for f in glob.glob(
    os.path.join(ROOT, "parameters_files", "*", "*", "*.yaml")))


def test_all_presets_found():
    assert len(PRESETS) == 24


@pytest.mark.parametrize("preset", PRESETS)
def test_loader_and_params_match_jax(preset):
    path = os.path.join(ROOT, preset)
    a, b = j_load(path), load_opencv_yaml(path)
    assert a.keys() == b.keys()
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray):
            assert vb.dtype == va.dtype and vb.shape == va.shape, k
            np.testing.assert_array_equal(vb, va, err_msg=k)
        else:
            assert type(vb) is type(va) and vb == va, (k, va, vb)
    pj, pt = JParams.from_yaml(path), SlamParams.from_yaml(path)
    for f in dataclasses.fields(pt):
        vj, vt = getattr(pj, f.name), getattr(pt, f.name)
        if isinstance(vj, np.ndarray):
            np.testing.assert_array_equal(vt, vj, err_msg=f.name)
        else:
            assert vt == vj, (f.name, vj, vt)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_builds_or_names_only_a5(preset):
    """Every preset builds (the name dates from when the loop-closing
    presets raised naming ROADMAP item A5)."""
    p = SlamParams.from_yaml(os.path.join(ROOT, preset))
    s = SlamSystem(p, device="cpu")
    assert s.mesh is None
    assert s.params.force_realtime
    assert (s.loopcloser is not None) == bool(p.buse_loop_closer)
    if p.buse_loop_closer:
        assert s.loopcloser.detector.index.native


def test_half_the_presets_run_unchanged():
    """All 24 presets run unchanged now (12 did before loop closing was
    ported): every setting is ported, and none asks for a device mesh."""
    ok = [f for f in PRESETS
          if SlamParams.from_yaml(os.path.join(ROOT, f)).n_devices <= 1]
    assert len(ok) == 24
    # half of them close loops: the accurate and average stereo ones
    lc = [f for f in PRESETS
          if SlamParams.from_yaml(os.path.join(ROOT, f)).buse_loop_closer]
    assert len(lc) == 12 and not any("mono" in f for f in lc)


def test_loader_parses_the_dialect(tmp_path):
    """Comments, quoted strings, YAML 1.1 scalars and a matrix whose data
    list spans lines."""
    f = tmp_path / "p.yaml"
    f.write_text(
        "%YAML:1.0\n---\n# comment\nname: 'a # b'  # trailing\n"
        "flag: true\nn: 12\nx: 1.5e-3\ny: 1e-3\nz: .5\nw: ~\n"
        "M: !!opencv-matrix\n  rows: 2\n  cols: 2\n  dt: d\n"
        "  data: [1, 2.5,\n     -3, 4e+1]\n")
    d = load_opencv_yaml(str(f))
    assert d["name"] == "a # b" and d["flag"] is True and d["n"] == 12
    assert d["x"] == 1.5e-3 and d["y"] == "1e-3" and d["z"] == 0.5
    assert d["w"] is None
    np.testing.assert_array_equal(d["M"], [[1.0, 2.5], [-3.0, 40.0]])
    j = j_load(str(f))
    np.testing.assert_array_equal(j.pop("M"), d.pop("M"))
    assert d == j
