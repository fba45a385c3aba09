"""One run of a benchmark cell (``benchmark/run.py``) on the card with what
its result line leaves out: the device's idle and busy time by program
span, the longest idle gaps cut along the spans the host was innermost in
across them, and the chunk calls' times inside and outside the traced
window.

    python3 scripts/bench_spans.py --workload NAME --seed N --seconds S
        [--trace 0|1] [--log-timings] [--out FILE]

The run is ``run.main``'s own (its result line printed as usual, its
check for the card's count kept); three wrappers, put back when it ends,
watch it: ``devtrace.reduce`` also keeps the traced window's events
(``spantrace.window``) and their attribution to the spans
(``spantrace.attribute``),
``SlamSystem.process_stereo_chunk`` is timed per call on the host clock,
each call marked as traced when ``torch.profiler`` was on, and
``--log-timings`` turns the program's
timers on in an untraced run (``--trace 0``), so that their cost is
measured without the profiler's. One JSON line goes to ``--out``
(appended) and to standard error: ``device`` (the card's name), ``spans``
(``span_n``, ``span_busy_s``, ``span_idle_s``, ``busy_s``, ``window_s``,
``frames``), ``gaps`` (the ``GAPS`` longest: each its start in ms from the
window's, its length and ``[label, ms]`` pieces), ``span_ms`` (per label
in the traced window: count, median, max and the first three span
lengths), ``chunk_ms`` (median and count of the window's calls, traced
and not) and ``timers`` (the window's labels: count and total ms).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

GAPS = 8


def span_ms(spans) -> dict:
    """label -> [count, median ms, max ms, the first three ms] of the
    (start_ns, end_ns, label) spans."""
    by: dict = {}
    for s, e, n in spans:
        by.setdefault(n, []).append((e - s) * 1e-6)
    return {n: [len(v), statistics.median(v), max(v), v[:3]] for n, v in by.items()}


def gap_pieces(t0, t1, spans, dev, k: int = GAPS) -> list:
    """The `k` longest idle gaps of ``spantrace.window``'s (t0, t1, spans,
    dev), as ``devtrace.reduce`` finds them, each cut along the innermost
    span open over it: [{"at_ms", "ms", "pieces"}]."""
    import spantrace
    _, _, gaps = spantrace.busy_union(dev, t0, t1)
    pieces = spantrace.innermost(spantrace.clipped(spans, t0, t1), t0, t1)
    out = []
    for g, a in gaps[:k]:
        b, cut = a + g, []
        for s, e, n in pieces:
            ov = min(e, b) - max(s, a)
            if ov <= 0:
                continue
            if cut and cut[-1][0] == n:
                cut[-1][1] += ov * 1e-6
            else:
                cut.append([n, ov * 1e-6])
        out.append(dict(at_ms=(a - t0) * 1e-6, ms=g * 1e-6, pieces=cut))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--log-timings", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import devtrace
    import run
    import spantrace
    import torch
    from ov2slam_tpu_torch.io.profiler import Profiler
    from ov2slam_tpu_torch.slam.manager import SlamSystem

    def table():
        return {k: [st.n, st.n * st.mean] for k, st in Profiler.instance().timers.items()}

    got: dict = {}
    reduce = devtrace.reduce

    def reduce_kept(prof, top=10):
        got["timers"] = table()     # before the trace is read (it collects)
        w = got["window"] = spantrace.window(prof)
        got["spans"] = None if w is None else spantrace.attribute(w)
        # the mode adds "frames" to this dict
        got["trace"] = reduce(prof, top)
        return got["trace"]

    calls = []
    chunk_call = SlamSystem.process_stereo_chunk

    def timed(self, frames):
        on = torch._C._autograd._profiler_enabled()
        t = time.perf_counter()
        r = chunk_call(self, frames)
        calls.append((1e3 * (time.perf_counter() - t), on))
        return r
    load = run.load_module

    def load_timed(path, name):
        mod = load(path, name)
        if args.log_timings and path.parent.name == "modes":
            params = mod.slam_params
            mod.slam_params = lambda cfg, log_timings: params(cfg, True)
        return mod
    devtrace.reduce = reduce_kept
    SlamSystem.process_stereo_chunk = timed
    run.load_module = load_timed
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", str(args.trace)])
    finally:
        devtrace.reduce = reduce
        SlamSystem.process_stereo_chunk = chunk_call
        run.load_module = load
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, _, tr = run.cell_spec(bench, args.workload)
    window_calls = calls[tr["warmup_frames"] // tr["chunk"]:]

    def med(rows):
        return [statistics.median(rows), len(rows)] if rows else None
    out = dict(workload=args.workload, seed=args.seed, rc=rc,
               device=torch.cuda.get_device_name(0), trace=args.trace,
               log_timings=args.log_timings,
               chunk_ms=dict(traced=med([ms for ms, on in window_calls if on]),
                             untraced=med([ms for ms, on in window_calls if not on])),
               timers=got.get("timers") or table())
    out["spans"] = dict(got.get("spans") or {},
                        frames=(got.get("trace") or {}).get("frames"))
    w = got.get("window")
    if w is not None:
        out["gaps"] = gap_pieces(*w)
        out["span_ms"] = span_ms(spantrace.clipped(w[2], w[0], w[1]))
    line = json.dumps(out)
    print(line, file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    import run as run_mod
    run_mod.pin_to_one_cpu()
    main()
