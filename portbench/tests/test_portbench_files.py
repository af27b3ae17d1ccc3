"""The benchmark's files: every one parses, every name BENCHMARK.json gives
has its file, and a cell added in a copy is found with no file edited."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} == {"problems_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_parses(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["n"] == 2 * data.get("contacts", data["n"] // 2)
    assert {"iterations_per_problem", "factorisations_per_problem", "power_iters",
            "origin"} <= set(data["k1_counts"])
    assert (ROOT / "portbench" / "problems" / f"{data['problem']}.py").is_file()
    assert (ROOT / "portbench" / "reference" / f"{data['problem']}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_files_parse(cell):
    spec = run.load_cell(cell["name"])
    assert spec["spec"]["pool"] >= 1
    assert spec["spec"]["limits"], "a cell compares at least one number"
    assert isinstance(spec["traffic"]["backward"], bool)
    assert {m["name"] for m in spec["end_to_end"]} == {"problems_per_s", "step_ms_p95", "setup_s"}
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    import importlib

    mod = importlib.import_module(f"portbench.metrics.{metric['name']}")
    assert callable(mod.read)


def test_a_cell_added_in_a_copy_is_found(tmp_path):
    """A later change adds a cell by adding files and a BENCHMARK.json entry."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "contact12.sim2", "config": "contact12", "traffic": "sim",
                               "chips": 1, "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "workloads" / "contact12.sim2.json").write_text(
        json.dumps({"pool": 3, "limits": {"l_err": 1.0}}))
    spec = run.load_cell("contact12.sim2", root=tmp_path)
    assert spec["spec"]["pool"] == 3 and spec["config"]["name"] == "contact12"
    assert "k4_ms" not in {m["name"] for m in spec["per_layer"]}
    with pytest.raises(run.Refused):
        run.load_cell("contact12.sim3", root=tmp_path)


def test_import_guard(monkeypatch):
    """Whole top-level names: jax and the JAX package are caught, the port
    and look-alike names are not."""
    import sys
    import types

    for name in ("diffqcqp_tpu_torch", "diffqcqp_tpu_torch.api", "jaxtyping", "jax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = run.forbidden_modules()
    assert not {m.split(".")[0] for m in before} & {"diffqcqp_tpu_torch", "jaxtyping", "jax_like"}
    monkeypatch.setitem(sys.modules, "diffqcqp_tpu.api", types.ModuleType("diffqcqp_tpu.api"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"diffqcqp_tpu.api", "jax"} <= set(run.forbidden_modules())
