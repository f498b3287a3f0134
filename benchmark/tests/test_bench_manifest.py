"""BENCHMARK.json against the rules its readers hold it to: names, units, keys,
and the files each entry is found by."""

import json
import re

from benchmark import compare, core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
MAN = core.manifest()


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for key in ("configs", "workloads"):
        assert len({n for k, n in names if k == key}) == len(MAN[key])
    metric_names = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)


def test_configs():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/") and (core.ROOT / c["file"]).is_file()
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (core.HERE / "reference" / f"{cfg['reference']}.py").is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        # weights: a checkpoint or a seeded init, exactly one; the init module exists
        assert ("weights" in cfg) != ("init" in cfg) and "weights_sha256" in cfg
        if "init" in cfg:
            assert NAME.match(cfg["init"]) and isinstance(cfg["weights_seed"], int)
            assert (core.HERE / "inits" / f"{cfg['init']}.py").is_file()
        else:
            assert (core.ROOT / cfg["weights"]).is_file()


def test_workloads():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (core.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((core.HERE / "limits" / f"{w['name']}.json").read_text())
        assert limits["numbers"] and limits["control"] in ("tf32", "fp8")
        assert set(limits["numbers"]) <= set(compare.NUMBERS)


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert (core.HERE / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:  # every cell reports setup_s, another end-to-end and a per-layer metric
        cell = core.load_cell(c)
        assert {m["name"] for m in cell.end_to_end} - {"setup_s"}
        assert cell.per_layer
