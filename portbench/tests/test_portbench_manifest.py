"""BENCHMARK.json and the data and code files it names."""
import json
import os

from conftest import CODE, ROOT
from harness.manifest import NAME, UNIT, Manifest, problems
from harness.runner import metric_reader


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keeps_the_rules():
    bench = _bench()
    assert problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    bench = _bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for bad in ("a b", "a,b", "a/b", "µs", "", "x" * 65):
        assert not NAME.match(bad)
    assert not UNIT.match("tokens per second") and UNIT.match("tokens/s")


def test_every_name_finds_its_files():
    bench, manifest = _bench(), Manifest(ROOT)
    for w in bench["workloads"]:
        cell = manifest.cell_file(w["name"])
        assert cell["traffic"] == w["traffic"]
        assert os.path.isfile(os.path.join(CODE, "jobs", cell["job"] + ".py"))
        assert set(cell["limits"]), w["name"]
        manifest.config(w["config"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]).read), m["name"]
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    manifest = Manifest(ROOT)
    for w in _bench()["workloads"]:
        e2e = [m["name"] for m in manifest.metrics(w["name"], traced=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics(w["name"], traced=True)
