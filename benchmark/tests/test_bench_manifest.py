"""BENCHMARK.json against the benchmark's contract: names, units, keys and
the files each name leads to."""

import re

from benchmark import harness
from benchmark.tests.conftest import ROOT, bench

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["benchmark"]
    assert all(text_ok(w) for w in b["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "benchmark/")
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and text_ok(w["why"])
        assert (ROOT / "benchmark" / "mixes" / f"{w['traffic']}.json"
                ).is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json"
                ).is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and text_ok(m["layer"])
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_enough():
    b = bench()
    for w in b["workloads"]:
        spec = harness.cell_spec(b, w["name"])
        e2e = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
