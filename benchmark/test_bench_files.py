"""Every configuration, traffic mix, mode and metric that BENCHMARK.json
names is found by its name under benchmark/ and parses; names and units use
only the allowed characters; every per-layer metric moves an end-to-end
metric that each of its cells reports.

A configuration is added as ``benchmark/configs/<name>.json`` with an entry
in ``configs``; a mix as ``benchmark/traffic/<name>.json`` (its ``mode``
names ``benchmark/modes/<mode>.py``); a metric as
``benchmark/metrics/<name>.py`` (a ``read(run)`` that returns a number or
None) with an entry in ``end_to_end`` or ``per_layer``.

    python -m pytest benchmark/test_bench_files.py -q
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["workloads"]) <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert len(json.dumps(BENCH)) < 64 * 1024
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
        assert len(c["reduced"]) <= 16 and LINE.match(c["source"]) and LINE.match(c["why"])
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["source"] == "device_trace"


def test_files_found_by_name_and_parse():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.parts[len(ROOT.parts)] == "benchmark", path
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert {"rig", "params", "limits"} <= set(cfg)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for w in BENCH["workloads"]:
        tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "modes" / f"{tr['mode']}.py").is_file()
        assert tr["frames"] > tr["warmup_frames"] >= tr["chunk"] >= 2
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = _module(HERE / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)


def test_every_config_used_and_every_cell_reports():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}

    def reporting(m):
        return set(m.get("workloads", cells))
    e2e = {m["name"]: reporting(m) for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert reporting(m) <= cells, m["name"]
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in s for n, s in e2e.items() if n != "setup_s")
        assert any(cell in reporting(m) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and reporting(m) <= e2e[m["moves"]], m["name"]


def test_readers_find_nothing_in_an_empty_run():
    run = dict(frames=0, window_s=0.0, setup_s=1.0, keyframes=0, timers={},
               syncs=None, trace=None, klt=None)
    for m in BENCH["per_layer"]:
        assert _module(HERE / "metrics" / f"{m['name']}.py").read(run) is None, m["name"]
