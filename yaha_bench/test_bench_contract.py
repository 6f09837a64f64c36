"""BENCHMARK.json and the files it names: the shape the benchmark's
contract asks for, the loaders that find a cell's parts by name, and an
import scan of the benchmark's sources.

    python -m pytest -q yaha_bench/test_bench_contract.py
"""
import ast
import json
import os
import re

import pytest

from yaha_bench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["yaha_bench"]
    assert bench["command"] == ["python3", "yaha_bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher") and e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and not (
                        key == "source" and group == "per_layer"):
                    assert one_line(e[key]), (e["name"], key)
    metrics = [n for m, n in names if m]
    assert len(set(metrics)) == len(metrics)


def test_configs(bench):
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("yaha_bench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == cfg["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert key in cfg["source_scale"]
        assert cfg["seed_phase"] in ("host", "device")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert len({c["source"] for c in bench["configs"]}) == len(
        bench["configs"])


def test_workloads(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        assert callable(harness.load_reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:
        ends = [m for m in bench["end_to_end"]
                if c in m.get("workloads", [c])]
        assert len(ends) >= 2
        assert any(c in m["workloads"] for m in bench["per_layer"])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) <= 2 for v in layers.values())


def test_load_cell_finds_every_part(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["pool_reads"] > 0
        names = {m["name"] for m in cell["per_layer"]}
        assert names & {"device.idle_pct", "device.idle_pct.devidx"}
        ends = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in ends and len(ends) >= 2
        # every per-layer metric of the cell moves one that it reports
        assert {m["moves"] for m in cell["per_layer"]} <= ends
    with pytest.raises(harness.UsageError):
        harness.load_cell("no.such_cell")


def sources():
    for root, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported_tops(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def string_constants(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_jax_and_no_old_benchmark():
    """No module of the benchmark imports jax, jaxlib, flax or the JAX
    package (top-level names compared whole: yaha_tpu_torch passes), and
    no code of it names the old benchmark's files (bench.py, chip_smoke.py,
    tools/, BENCH_*)."""
    forbidden = {"jax", "jaxlib", "flax", "yaha_tpu"}
    old = re.compile(r"bench\.py|chip_smoke|BENCH_|MULTICHIP_|tools/")
    for path in sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        assert not forbidden & set(imported_tops(tree)), path
        if not os.path.basename(path).startswith("test_"):
            assert not [s for s in string_constants(tree) if old.search(s)]


def test_reference_imports_nothing_of_the_port():
    for path in sources():
        if os.sep + "reference" + os.sep in path:
            with open(path) as f:
                tops = set(imported_tops(ast.parse(f.read())))
            assert not {"yaha_tpu_torch", "yaha_tpu", "jax"} & tops, path
