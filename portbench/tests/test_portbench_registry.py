"""The harness finds every part by name, and a part added as a file is
found with no other file edited."""
import json
import shutil

import pytest

from portbench.harness import registry


def test_every_cell_resolves():
    b = registry.Bench()
    assert b.cells() == ["phi4mini-train-s2048", "resnet18-train-b512",
                         "resnet18-q8-b1000", "phi4mini-prefill-s256-2048"]
    for cell in b.cells():
        spec = b.cell(cell)
        assert b.config(spec["config"])["name"] == spec["config"]
        traffic = b.traffic(spec["traffic"])
        assert hasattr(b.driver(traffic["driver"]), "Cell")
        assert b.limits(cell)["limits"]


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(section):
    b = registry.Bench()
    for m in b.spec[section]:
        assert b.metric_path(m["name"]).is_file(), m["name"]
        assert callable(b.metric(m["name"]).read)


def test_metrics_for_follows_the_workloads_key():
    b = registry.Bench()
    names = {m["name"] for m in b.metrics_for("resnet18-q8-b1000",
                                              "end_to_end")}
    assert names == {"images_per_s.cnn_q8", "step_ms_p95.cnn_q8",
                     "setup_s"}
    names = {m["name"] for m in b.metrics_for("phi4mini-train-s2048",
                                              "per_layer")}
    assert "optimizer_ms.lm_train" in names
    assert not any(n.endswith(".cnn_q8") for n in names)


@pytest.mark.parametrize("part", ["cell", "traffic", "driver", "metric"])
def test_a_new_file_is_found(tmp_path, part):
    """A copy of the benchmark gains a cell, a traffic mix, a driver and a
    metric, each by adding files (and BENCHMARK.json's entries); the
    harness lists and loads them."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((registry.CHECKOUT / "BENCHMARK.json").read_text())
    (root / "traffic" / "tiny-mix.json").write_text(
        json.dumps({"driver": "toy", "batch": 2}))
    (root / "drivers" / "toy.py").write_text(
        "class Cell:\n    unit = 'images'\n")
    (root / "metrics" / "toy_ms.py").write_text(
        "def read(run):\n    return 1.0\n")
    (root / "workloads" / "toy-cell.json").write_text(
        json.dumps({"limits": {"logit_err": 0.0}}))
    spec["workloads"].append({"name": "toy-cell", "config":
                              "resnet18-cifar10", "traffic": "tiny-mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "toy_ms.cnn", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "card", "moves": "images_per_s.cnn_q8",
                              "workloads": ["toy-cell"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    b = registry.Bench(path, root)
    if part == "cell":
        assert "toy-cell" in b.cells()
        assert b.limits("toy-cell")["limits"] == {"logit_err": 0.0}
    elif part == "traffic":
        assert "tiny-mix" in b.traffic_names()
        assert b.traffic(b.cell("toy-cell")["traffic"])["driver"] == "toy"
    elif part == "driver":
        assert "toy" in b.driver_names()
        assert b.driver("toy").Cell.unit == "images"
    else:
        names = [m["name"] for m in b.metrics_for("toy-cell", "per_layer")]
        assert "toy_ms.cnn" in names
        assert b.metric("toy_ms.cnn").read(None) == 1.0
