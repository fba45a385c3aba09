"""The benchmark of ov2slam_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the preset, the rig, the limits of the
correctness check) and a traffic mix (``traffic/<name>.json``: the
generator's parameters and the mode that feeds the system,
``modes/<mode>.py``). The metrics are read by ``metrics/<name>.py``,
each from the run's counters, spans and trace; ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones. Everything is
found by name, so a configuration, a mix, a mode or a metric is added by
adding its file and its entry.

After the window, ``reference.py`` judges what the timed path produced
against the generator's ground truth; each compared number is printed
beside its limit, last on standard error and last in the result line. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), then ``checks``.

The process runs on one CPU (``pin_to_one_cpu``). Exits with 2, printing
no result, without the cards the cell asks for; with 1 when the program
cannot be imported, or when a JAX module is loaded in this process once
the window, the metric readers and the reference have run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ov2slam_tpu")
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """(cell, configuration, traffic) of a workload of BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"({', '.join(sorted(cells))})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end ones, or with
    the trace its per-layer ones."""
    rows = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in rows if cell in m.get("workloads", [cell])]


def require_chips(n: int) -> None:
    """Exit 2, with no result, unless this process sees n CUDA cards."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"benchmark: needs {n} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def pin_to_one_cpu() -> None:
    """Run this process, and every thread it starts later, on one CPU: the
    last it may use. Called before torch loads, so that its thread pools and
    the CUDA driver's threads inherit the mask. Free to move between CPUs,
    the non-keyframe chunks of one run took 87 to 137 ms (10th to 90th
    percentile) on an H100 machine; pinned, 87 to 89 ms, or about 110 ms
    where the machine ran at its slower pace."""
    try:
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    except OSError as e:
        print(f"benchmark: could not pin to one CPU: {e}", file=sys.stderr)


def set_cache_dirs() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths (the
    program builds its own libraries into ov2slam_tpu_torch/build/)."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))


def main(argv=None, device: str = "cuda", spec=None, controls=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="run a control or a planted fault of the correctness check "
                    "(controls.py)")
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = spec or cell_spec(bench, args.workload)
    require_chips(int(cell["chips"]))
    try:
        import ov2slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program cannot be imported: {e}", file=sys.stderr)
        return 1
    import torch

    import reference
    if args.control:
        import controls as controls_mod
        found = {**controls_mod.CONTROLS, **controls_mod.FAULTS}
        controls = tuple(controls) + (found[args.control],)
    mode = load_module(HERE / "modes" / f"{traffic['mode']}.py",
                       f"mode_{traffic['mode']}")
    res = mode.run(dict(config=config, traffic=traffic, device=device,
                        seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), t0=T0, controls=controls))
    nums = reference.numbers(res["record"])
    limits = config["limits"]
    over = reference.verdict(nums, limits)
    run = res["run"]
    metrics = {}
    for m in metrics_of(bench, cell["name"], bool(args.trace)):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": not over and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    tr = run.get("trace")
    if args.trace:
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            out["breakdown"] = {"device_ops": tr["device_ops"],
                                "idle_gaps": tr["idle_gaps"]}
    checks = {k: {"value": nums.get(k), "limit": lim} for k, lim in limits.items()}
    checks["failed_frames"] = {"value": res["failed"], "limit": 0}
    out["checks"] = checks
    info = {k: run.get(k) for k in ("frames", "window_s", "setup_s", "setup_parts",
                                    "first_chunks", "keyframes", "landmarks",
                                    "map_capacity", "trace_read_s")}
    print(f"benchmark: {cell['name']} seed {args.seed}: {json.dumps(info)}",
          file=sys.stderr)
    if tr is not None or run.get("klt"):
        print(f"benchmark: trace {json.dumps({k: tr[k] for k in ('busy_s', 'window_s', 'n_device_ops', 'frames')} if tr else None)}"
              f" klt {json.dumps(run.get('klt'))}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    # last, once the readers and the reference have run too
    bad_mods = forbidden_modules()
    if bad_mods:
        print(f"benchmark: JAX modules loaded: {', '.join(bad_mods)}",
              file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    pin_to_one_cpu()
    sys.exit(main())
