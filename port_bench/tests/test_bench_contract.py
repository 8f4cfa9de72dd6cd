"""BENCHMARK.json and every file it names: present, parsed, and within the
benchmark's rules of form."""

import ast
import json
import os
import re

import pytest

from port_bench import common
from port_bench.reference import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH_CHARS.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for w in bench["command"][1:]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of the full 24 cells fits in its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"] not in files and any(c["file"].startswith(p + "/")
                                               for p in bench["paths"])
        files.add(c["file"])
        cfg = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["assumed"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert os.path.basename(c["file"]) == c["name"] + ".json"


def test_workloads_name_their_files(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = common.load_json(common.named_file("traffic", w["traffic"]))
        assert os.path.exists(os.path.join(common.HERE, "kinds", traffic["kind"] + ".py"))
        limits = common.load_json(common.named_file("limits", w["name"]))
        assert limits and all(isinstance(v, (int, float)) and v > 0 for v in limits.values())


def test_metrics(bench):
    names = set()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in e2e
        assert os.path.exists(common.named_file("metrics", m["name"], ".py"))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _reports(bench, cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_metric_moves_one_that_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in bench["workloads"]])
        for cell in cells:
            assert _reports(bench, cell, e2e[m["moves"]]), (m["name"], cell)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if _reports(bench, w["name"], m)]
        layer = [m["name"] for m in bench["per_layer"] if _reports(bench, w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for root, dirs, files in os.walk(os.path.join(common.ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(root, f), common.ROOT)
                assert PATH_CHARS.match(rel), rel


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module + "." if node.module else "")
            yield from (base + a.name for a in node.names)


def test_reference_imports_nothing_of_the_port_or_jax():
    """Nothing from outside reference/ but the counts' shared arithmetic,
    ``flops.py``, which itself imports nothing but the registry."""
    ref = os.path.join(common.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                top = name.lstrip(".").split(".")[0]
                assert top not in common.FORBIDDEN + (common.PORT,), (f, name)
                if name.startswith("..") and name != "..flops":
                    pytest.fail(f"{f} imports {name} from outside reference/")
    assert set(_imports(os.path.join(common.HERE, "flops.py"))) == {
        "__future__.annotations", ".reference.registry"}


def test_nothing_of_the_benchmark_imports_jax():
    for root, _, files in os.walk(common.HERE):
        for f in files:
            if f.endswith(".py"):
                for name in _imports(os.path.join(root, f)):
                    assert name.lstrip(".").split(".")[0] not in common.FORBIDDEN, (f, name)


def test_every_configuration_names_a_model_the_registry_finds(bench):
    for c in bench["configs"]:
        model = common.load_json(os.path.join(common.ROOT, c["file"]))["model"]
        assert registry.find(model).MODEL == model, c["name"]


def _code_strings(path):
    """The string constants of a file that are not docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs], tree


def test_no_harness_file_names_a_model():
    """Only a model's own module names it: the harness finds it through the
    registry, with no table of models and no branch on a configuration's
    ``model``."""
    models = set(registry.declarations())
    kinds = os.path.join(common.HERE, "kinds")
    files = [os.path.join(common.HERE, f) for f in ("flops.py", "common.py", "run.py",
                                                    "calibrate.py", "reference/train.py")]
    files += [os.path.join(kinds, f) for f in os.listdir(kinds) if f.endswith(".py")]
    for path in files:
        strings, tree = _code_strings(path)
        named = [(s, m) for s in strings for m in models if m in s]
        assert not named, (path, named)
        assert not any(isinstance(n, ast.Name) and n.id == "MODELS" for n in ast.walk(tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                keys = [n.slice.value for n in ast.walk(node) if isinstance(n, ast.Subscript)
                        and isinstance(n.slice, ast.Constant)]
                assert "model" not in keys, (path, ast.unparse(node))
