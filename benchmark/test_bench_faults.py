"""The correctness check fails what it must.

On the CPU (no card needed): a whole run of ``run.main`` at a small size
(160 frames of the EuRoC cell, 32 of them warm-up), the harness's look for
a card skipped, first sound (``correct`` true), then once with each fault
of ``controls.FAULTS`` planted in the timed path, and ``correct`` must
come out false: the chunk step returning its input state; half of each
chunk's frames left out; every frame's pose, or one frame in eight, moved
5 mm; every KLT point moved 1 px; every landmark the local BA writes back
moved 5% farther from its anchor; the local BA returning its input. A
four-chip cell would add the exchange between chips left out; every cell
of this benchmark runs on one card.

On the card (marked ``cuda``; skips elsewhere): the lower-precision
control at each cell's own size and window must come out as not correct.

    python -m pytest benchmark/test_bench_faults.py -q
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import controls  # noqa: E402
import run  # noqa: E402
import world  # noqa: E402

SEED = 2 ** 33 + 17


def _restore_after(monkeypatch):
    """Every program function a control or a fault replaces is put back
    once the test ends."""
    from ov2slam_tpu_torch.ops import klt as klt_mod
    from ov2slam_tpu_torch.slam import frontend as fe_mod
    from ov2slam_tpu_torch.slam import mapper as mapper_mod
    for mod, name in ((fe_mod, "frame_chunk_step"), (fe_mod, "cast_pyr"),
                      (klt_mod, "fb_klt_tracking"),
                      (mapper_mod, "triangulate_stereo"),
                      (mapper_mod, "triangulate_temporal")):
        monkeypatch.setattr(mod, name, getattr(mod, name))


def _cpu_spec(workload="euroc_vo_cruise"):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, tr = run.cell_spec(bench, workload)
    tr = dict(tr, frames=160, warmup_frames=32,
              world=dict(tr["world"], tex_size=512))
    return cell, cfg, tr


_FRAMES = {}
_RENDER = world.render_sequence


def _render_once(room, rig, poses):
    """The frames of every run here come from one seed: render them once."""
    key = (rig, poses.tobytes())
    if key not in _FRAMES:
        _FRAMES[key] = _RENDER(room, rig, poses)
    return _FRAMES[key]


def _run_cpu(capsys, monkeypatch, controls=()):
    monkeypatch.setattr(run, "require_chips", lambda n: None)
    monkeypatch.setattr(world, "render_sequence", _render_once)
    _restore_after(monkeypatch)
    torch.set_num_threads(4)
    rc = run.main(["--workload", "euroc_vo_cruise", "--seed", str(SEED),
                   "--seconds", "600", "--trace", "0"], device="cpu",
                  spec=_cpu_spec(), controls=controls)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys, monkeypatch):
    out = _run_cpu(capsys, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 128 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
def test_fault_is_not_correct(fault, capsys, monkeypatch):
    out = _run_cpu(capsys, monkeypatch, (controls.FAULTS[fault],))
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["lower_precision"])
@pytest.mark.parametrize("workload", ["euroc_vo_cruise", "tartanair_vo_cruise"])
def test_control_is_not_correct_on_the_card(control, workload, capsys, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _restore_after(monkeypatch)
    seconds = run.load_json(run.ROOT / "BENCHMARK.json")["run_seconds"]
    rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", "0", "--control", control])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]
