"""The benchmark's layout: names and units of allowed characters and length,
everything found by name (a new configuration, traffic mix, cell and
per-layer metric need new files only), and what its modules load."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from h100bench import harness

ROOT = harness.ROOT


def test_names_units_and_files():
    bench = harness.benchmark()
    assert harness.validate(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        for w in m["workloads"]:
            # every cell that reports a metric reports the one it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert all(len(v) == 1 for v in layers.values())
    for w in bench["workloads"]:
        assert w["chips"] == 1
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


def _tree_hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_needs_new_files_only(tmp_path):
    """A copy of the layout gains a configuration, a traffic mix, a cell
    and a per-layer metric by new files and new entries alone; the
    harness finds and validates them by name."""
    here = tmp_path / "h100bench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    before = _tree_hashes(here)
    cfg = harness.load_json(here / "configs" / "lsnet_r50_bbox.json")
    cfg["model"]["bbox_head"]["num_classes"] = 20
    (here / "configs" / "lsnet_r50_voc.json").write_text(json.dumps(cfg))
    mix = harness.load_json(here / "traffic" / "detect_b8.json")
    mix["batch"] = 1
    (here / "traffic" / "detect_b1.json").write_text(json.dumps(mix))
    (here / "limits" / "r50_voc.detect_b1.json").write_text(json.dumps(
        {"maps_rel_err": {"limit": 0.1}}))
    (here / "layer_metrics" / "batches.detect.py").write_text(
        "def read(ctx):\n    return float(ctx['record']['batches'])\n")
    bench["configs"].append({
        "name": "lsnet_r50_voc", "source": "https://arxiv.org/abs/2104.04899",
        "file": "h100bench/configs/lsnet_r50_voc.json", "reduced": [],
        "why": "a test configuration"})
    bench["workloads"].append({
        "name": "r50_voc.detect_b1", "config": "lsnet_r50_voc",
        "traffic": "detect_b1", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "batches.detect", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "device: H100",
        "moves": "detect_img_s", "workloads": ["r50_voc.detect_b1"]})
    for m in bench["end_to_end"]:
        if "detect_img_s" == m["name"]:
            m["workloads"].append("r50_voc.detect_b1")
    assert harness.validate(bench, here) == []
    files = harness.cell_files(bench, "r50_voc.detect_b1", here)
    assert files["mix"]["batch"] == 1
    assert files["config"]["model"]["bbox_head"]["num_classes"] == 20
    assert [m["name"] for m in files["per_layer"]] == ["batches.detect"]
    read = harness.metric_reader("batches.detect", here)
    assert read({"record": {"batches": 7}}) == 7.0
    after = _tree_hashes(here)
    assert {k: v for k, v in after.items() if k in before} == before
    # a name with a character outside the allowed set is refused
    bench["workloads"][-1]["name"] = "r50 voc"
    assert harness.validate(bench, here)


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax():
    bench = harness.benchmark()
    metrics = [m["name"] for m in bench["per_layer"]]
    code = ("import sys, json\n"
            "import h100bench.run, h100bench.readings\n"
            "from h100bench import harness\n"
            "import h100bench.entries.detect, h100bench.entries.train\n"
            f"for m in {metrics!r}:\n"
            "    harness.metric_reader(m)\n"
            "import lsnet_torch.apis\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    tops = _loaded(code)
    assert "h100bench" in tops and "lsnet_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "optax", "orbax",
                       "lsnet_tpu", "__graft_entry__", "bench", "tools"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import h100bench.reference.model, h100bench.reference.loss\n"
            "import h100bench.reference.decode, h100bench.control\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    tops = _loaded(code)
    assert "h100bench" in tops
    assert not tops & {"lsnet_torch", "jax", "lsnet_tpu"}
