"""BENCHMARK.json against the contract's shape, every name resolved to its
files, and a new cell added by new files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
            names.append((group, entry["name"]))
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra, m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = registry.workload(cell)
    own = registry.load_json(registry.ROOT / "workloads" / f"{cell}.json")
    assert set(own) == {"loop", "check", "limits"}
    assert {k: spec[k] for k in entry} == entry
    assert entry["chips"] == 1
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (registry.REPO / cfg["file"]).is_file()
    assert registry.config(entry["config"])["reduced"] == cfg["reduced"]
    assert hasattr(registry.config_module(entry["config"]), "System")
    assert registry.traffic(entry["traffic"])
    assert hasattr(registry.loop_module(spec["loop"]), "run")
    e2e, per_layer = registry.cell_metrics(cell, BENCH)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert hasattr(registry.metric_module(m["name"]), "read")
        if m["name"].endswith("_roofline"):
            roof = registry.roofline_module(m["name"][:-len("_roofline")])
            assert roof.CALLERS and callable(roof.bound_s)
        assert m["moves"] in {x["name"] for x in e2e}
    assert set(spec["limits"]) and set(spec["check"])


def test_every_metric_and_config_is_used():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_a_new_cell_is_new_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix, a per-layer
    metric and a roofline by new files and new entries; every file that was
    there is unchanged, and the harness resolves the new pieces by name."""
    root = tmp_path / "repo"
    shutil.copytree(registry.ROOT, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    pb = root / "perfbench"
    cell = BENCH["workloads"][0]
    spec = registry.workload(cell["name"])
    (pb / "traffic" / "dummy_mix.json").write_text(
        json.dumps({**registry.traffic(spec["traffic"]), "steps": 10}))
    (pb / "workloads" / "dummy.cell.json").write_text(
        json.dumps({k: spec[k] for k in ("loop", "check", "limits")}))
    (pb / "metrics" / "dummy_ms.py").write_text(
        "def read(records):\n    return records.get('dummy')\n")
    (pb / "roofline" / "dummy_fn.py").write_text(
        "CALLERS = ()\n\ndef bound_s(*a, **k):\n    return 0.0\n")
    (pb / "metrics" / "dummy_fn_roofline.py").write_text(
        "from perfbench.metrics._common import roofline_pct\n\n"
        "def read(records):\n    return roofline_pct(records, 'dummy_fn')\n")
    bench["workloads"].append({"name": "dummy.cell", "config": cell["config"],
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for name in ("dummy_ms", "dummy_fn_roofline"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "program_span", "layer": "test",
                                   "moves": "setup_s", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import registry as r\n"
        "b = r.benchmark(); s = r.workload('dummy.cell')\n"
        "assert r.traffic(s['traffic'])['steps'] == 10\n"
        "e2e, pl = r.cell_metrics('dummy.cell', b)\n"
        "names = [m['name'] for m in pl]\n"
        "assert 'dummy_ms' in names and 'dummy_fn_roofline' in names\n"
        "assert r.metric_module('dummy_ms').read({'dummy': 2.0}) == 2.0\n"
        "assert r.metric_module('dummy_fn_roofline').read({}) is None\n"
        "assert r.roofline_module('dummy_fn').CALLERS == ()\n"
        "r.config_module(s['config']).System; r.loop_module(s['loop']).run\n"
        "print('ok')\n" % str(root))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=root, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path, data in before.items():
        assert path.read_bytes() == data, path
