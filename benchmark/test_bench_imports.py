"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the program's own name begins with the JAX
package's), and the correctness reference imports nothing of the program.

    python -m pytest benchmark/test_bench_imports.py -q
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ov2slam_tpu"}
PROGRAM = "ov2slam_tpu_torch"
# the reference, and the modules it may read from: plain NumPy
REFERENCE = ("reference",)


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    running `code` with benchmark/ and the checkout on its path."""
    prog = (f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]\n"
            + code + "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(HERE.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_readers_and_reference_import_no_jax():
    metrics = sorted(p.stem for p in (HERE / "metrics").glob("*.py"))
    modes = sorted(p.stem for p in (HERE / "modes").glob("*.py"))
    code = "\n".join([
        "import run, reference, world, world_np, kltbound, devtrace, controls",
        "import ov2slam_tpu_torch.slam.manager, ov2slam_tpu_torch.slam.graphs",
        "for name in %r: run.load_module(run.HERE / 'metrics' / (name + '.py'), 'm_' + name.replace('.', '_'))" % (metrics,),
        "for name in %r: run.load_module(run.HERE / 'modes' / (name + '.py'), 'd_' + name)" % (modes,),
    ])
    loaded = _loaded(code)
    assert PROGRAM in loaded
    assert not (loaded & FORBIDDEN), sorted(loaded & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded("import " + ", ".join(REFERENCE))
    assert PROGRAM not in loaded and not (loaded & FORBIDDEN)
    for name in REFERENCE:
        tree = ast.parse((HERE / f"{name}.py").read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] in {"__future__", "typing", "numpy"}, (name, m)


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, str(HERE))
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["ov2slam_tpu_torch_x"] = sys
        sys.modules["jaxish"] = sys
        assert not {m for m in run.forbidden_modules() if m in ("ov2slam_tpu_torch_x", "jaxish")}
        sys.modules["jax.numpy"] = sys
        assert "jax.numpy" in run.forbidden_modules()
    finally:
        for k in ("ov2slam_tpu_torch_x", "jaxish", "jax.numpy"):
            if k not in saved:
                sys.modules.pop(k, None)


def test_jax_loaded_after_the_window_prints_no_result(capsys, monkeypatch):
    """A metric reader that loads JAX (here a stand-in module named jax)
    once the window has closed: the run exits 1 and prints no result."""
    import types
    sys.path.insert(0, str(HERE))
    import reference
    import run
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "jax", None)
    monkeypatch.delitem(sys.modules, "jax")

    def read(r):
        sys.modules["jax"] = types.ModuleType("jax")
        return 1.0
    mode = types.SimpleNamespace(run=lambda ctx: dict(
        record={}, run={}, attempted=8, failed=0, memory_peak_bytes=0))
    reader = types.SimpleNamespace(read=read)
    monkeypatch.setattr(run, "require_chips", lambda n: None)
    monkeypatch.setattr(run, "load_module", lambda path, name:
                        mode if path.parent.name == "modes" else reader)
    monkeypatch.setattr(reference, "numbers", lambda rec: {})
    workload = json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    rc = run.main(["--workload", workload, "--seed", "1", "--seconds", "1",
                   "--trace", "0"], device="cpu")
    err = capsys.readouterr()
    assert rc == 1
    assert err.out.strip() == ""
    assert "jax" in err.err
