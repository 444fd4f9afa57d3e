"""BENCHMARK.json against the contract's characters and keys, and the
harness's files found by name: a new configuration, traffic mix, metric
and cell are files and entries, with no edit to a file already there."""
import json
import re

import pytest

from bench_tiny import BENCH, ROOT, spec_of, tiny_copy

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmarks"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / bench["command"][1]).is_file()


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.fullmatch(e[key])
        for key in e.get("reduced", []):
            assert NAME.fullmatch(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_metric_entries(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [
    w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_files_found_by_name(bench, cell):
    spec = spec_of(ROOT)
    entry = spec.cell(cell)
    cfg = spec.config(entry["config"])
    traffic = spec.traffic(entry["traffic"])
    limits = spec.limits(cell)
    assert cfg["network"] in ("VQ_VAE_z32", "VQ_VAE_z16")
    assert traffic["ranks"] == entry["chips"]
    assert set(limits) <= {"loss_gap", "grad_gap", "change_gap", "val_gap"}
    wanted = spec.end_to_end(cell) + spec.per_layer(cell)
    assert {"setup_s"} < {m["name"] for m in wanted}
    for m in wanted:
        assert callable(spec.reader(m["name"]))


def test_config_files_are_their_entries(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmarks/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_additions_need_no_edit(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added to a copy
    as new files and entries are found, and no file of the copy that was
    there before changed."""
    root = tiny_copy(tmp_path)
    bd = root / "benchmarks"
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()}
    (bd / "configs" / "new_net.json").write_text(json.dumps(
        {"name": "new_net", "source": "s", "network": "VQ_VAE_z16",
         "num_hiddens": 16, "reduced": []}))
    (bd / "traffic" / "new_mix.json").write_text(json.dumps(
        {"patches": 64, "patch_size": 32, "trajectory_frames": [4, 8],
         "ranks": 1, "trace_seconds": 1}))
    (bd / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (bd / "limits" / "new_net.new_mix.json").write_text(
        json.dumps({"loss_gap": {"limit": 1e-3}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new_net", "source": "s", "reduced": [],
                             "file": "benchmarks/configs/new_net.json",
                             "why": "w"})
    bench["workloads"].append({"name": "new_net.new_mix",
                               "config": "new_net", "traffic": "new_mix",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new.metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["new_net.new_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = spec_of(root)
    assert spec.config("new_net")["num_hiddens"] == 16
    assert spec.traffic("new_mix")["patches"] == 64
    assert spec.limits("new_net.new_mix")["loss_gap"]["limit"] == 1e-3
    layer = [m["name"] for m in spec.per_layer("new_net.new_mix")]
    assert layer == ["new.metric"]
    assert spec.reader("new.metric")(None) == 42.0
    assert [m["name"] for m in spec.end_to_end("new_net.new_mix")] == \
        ["setup_s"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_benchmark_files_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel
