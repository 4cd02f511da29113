"""BENCHMARK.json against the benchmark's contract: keys, names and units,
the files each name leads to, the bounds and the run length."""

import json
import re

import pytest

from conftest import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_length_fits_a_full_check():
    rs = manifest()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    m = manifest()
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files) and 1 <= len(files) <= 24
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(conf["reduced"])


def test_workloads_lead_to_their_files():
    m = manifest()
    names = [w["name"] for w in m["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((ROOT / "portbench" / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())


def test_metrics():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in seen
        seen.add(x["name"])
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher") and x["source"] in SOURCES
        assert set(x.get("workloads", [])) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{x['name']}.py").is_file()
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(x["layer"]) and x["moves"] in e2e
        moved = e2e[x["moves"]]
        assert set(x["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:   # every cell: setup_s, one other end-to-end metric, one per-layer metric
        reported = [x["name"] for x in m["end_to_end"] if cell in x.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in x.get("workloads", cells) for x in m["per_layer"])


@pytest.mark.parametrize("name", [x["name"] for x in manifest()["per_layer"] + manifest()["end_to_end"]])
def test_reader_loads(name):
    from portbench import harness

    assert callable(harness.reader(name))
