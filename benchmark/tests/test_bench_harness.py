"""The harness finds cells, configurations, traffic and metrics as files;
it fails without a card; it loads no JAX and no JAX package."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

from conftest import BENCH, ROOT

from harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "deblur4dgs_tpu")
PORT = "deblur4dgs_tpu_torch"


def _copy_benchmark(dst):
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    _copy_benchmark(tmp_path)
    bench = tmp_path / "benchmark"
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "stereo_low.json").read_text())
    cfg["frame"]["width"] = 640
    (bench / "configs" / "wide_low.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "stage2.json").read_text())
    traffic["traced_steps"] = 5
    (bench / "traffic" / "stage2_long.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "wide.stage2_long.json").write_text(json.dumps(
        {"config": "wide_low", "traffic": "stage2_long",
         "limits": {"loss": 1.0, "grad": 1.0, "change": 1.0}}))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps)\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][1], name="wide_low",
                                    file="benchmark/configs/wide_low.json"))
    manifest["workloads"].append({"name": "wide.stage2_long",
                                  "config": "wide_low",
                                  "traffic": "stage2_long", "chips": 1,
                                  "why": "test"})
    manifest["per_layer"].append(
        {"name": "steps_traced", "unit": "steps", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "step_ms",
         "workloads": ["wide.stage2_long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = spec.load_cell("wide.stage2_long", bench_dir=str(bench),
                          root=str(tmp_path))
    assert cell.config["frame"]["width"] == 640
    assert cell.traffic["traced_steps"] == 5
    assert [m["name"] for m in cell.per_layer][-1] == "steps_traced"
    read = spec.metric_reader("steps_traced", bench_dir=str(bench))
    assert read(SimpleNamespace(trace=SimpleNamespace(steps=5))) == 5.0
    # the cells already there are found as before, and no file changed
    old = spec.load_cell("high.stage2", bench_dir=str(bench),
                         root=str(tmp_path))
    assert "steps_traced" not in [m["name"] for m in old.per_layer]
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())


def test_every_cell_and_metric_of_the_manifest_has_its_files():
    manifest = json.loads(Path(ROOT, "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        cell = spec.load_cell(w["name"])
        assert set(cell.limits) == {"loss", "grad", "change"}
    for m in manifest["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for c in manifest["configs"]:
        assert Path(ROOT, c["file"]).is_file()


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "high.stage2",
         "--seed", "2200000123", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_fails_without_a_card():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_run_fails_with_only_the_benchmark(tmp_path):
    _copy_benchmark(tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def _imports(path):
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return [m.split(".")[0] for m in mods if m]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    files = [p for p in Path(BENCH).rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for f in files:
        tops = set(_imports(f))
        assert not tops & set(FORBIDDEN), (f, tops)
        if "reference" in f.relative_to(BENCH).parts:
            assert PORT not in tops, f


def _loaded_after(modules, then=""):
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"{then}"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = ["run", "calibrate", "harness.runner", "harness.peaks",
            "deblur4dgs_tpu_torch.train.trainer",
            "deblur4dgs_tpu_torch.models.pwcnet"]
    metrics = [m.stem for m in Path(BENCH, "metrics").glob("*.py")]
    loaded = _loaded_after(
        mods, "from harness.spec import metric_reader\n"
        f"for m in {metrics!r}: metric_reader(m)\n")
    assert not loaded & set(FORBIDDEN), loaded


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = [f"reference.{p.relative_to(Path(BENCH, 'reference')).with_suffix('').as_posix().replace('/', '.')}"
            for p in Path(BENCH, "reference").rglob("*.py")
            if p.name != "__init__.py"]
    loaded = _loaded_after(mods)
    assert not loaded & set(FORBIDDEN + (PORT,)), loaded
