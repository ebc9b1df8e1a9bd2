"""BENCHMARK.json against its files: every cell names a configuration, a
traffic mix and metric readers that exist, names and units use only the
allowed characters, and each configuration file is the upstream
configuration with only its `reduced` keys changed."""
from __future__ import annotations

import json
import re

import pytest

from perfbench.tests.tiny import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    for n in names + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_exist(cell):
    w = {c["name"]: c for c in MAN["workloads"]}[cell]
    entry = {c["name"]: c for c in MAN["configs"]}[w["config"]]
    assert (ROOT / entry["file"]).is_file()
    assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (ROOT / "perfbench" / "metrics"
                    / f"{m['name']}.py").is_file(), m["name"]


def test_metric_contract():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in MAN["workloads"]}


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_is_upstream_but_reduced(name):
    from eags_slam_torch.config import load_config

    entry = {c["name"]: c for c in MAN["configs"]}[name]
    f = json.loads((ROOT / entry["file"]).read_text())
    assert f["reduced"] == entry["reduced"] and f["source"] == entry["source"]
    upstream = load_config(f["upstream"].split()[0])
    for key in set(upstream) | set(f["config"]):
        if key in entry["reduced"]:
            continue
        assert f["config"].get(key) == upstream.get(key), key
