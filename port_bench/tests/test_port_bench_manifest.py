"""BENCHMARK.json against the contract's rules that need no chip."""

import json
import re

from bench_fixture import REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_keys_names_and_units():
    assert set(MAN) == KEYS
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in metrics])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert len(json.dumps(MAN)) < 64 * 1024


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        cell = w["name"]
        mine = [m for m in MAN["end_to_end"] if _reports(cell, m)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert [m for m in MAN["per_layer"] if _reports(cell, m)]
    # every per-layer metric's cells report the metric it moves
    for m in MAN["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            assert _reports(cell, moves), (m["name"], cell)


def test_every_piece_has_its_file():
    pb = REPO / "port_bench"
    for w in MAN["workloads"]:
        assert (pb / "traffic" / f"{w['traffic']}.json").is_file()
        assert (pb / "limits" / f"{w['name']}.json").is_file()
    for c in MAN["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file()
    # a layer named twice is named alike
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
