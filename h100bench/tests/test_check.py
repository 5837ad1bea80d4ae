"""The check decides ``correct``: a run is driven on the CPU past the look
for a card (narrow models, float32, a small canvas), with the cells' own
limits; sound runs come out correct, and runs with the timed path broken
underneath, and the control, come out not correct."""

from __future__ import annotations

import io

import pytest

from h100bench import harness
from h100bench.run import run_cell

CELLS = {"detect": ("x101_bbox.detect_b8", "r50_bbox.detect_b8"),
         "train": ("r50_bbox.train_b8",)}
MODELS = {"x101_bbox": "x101_flagship_cfg", "r50_bbox": "flagship_r50_cfg"}


def tiny(cell: str):
    from lsnet_torch import configs
    files = harness.cell_files(harness.benchmark(), cell)
    files["config"] = {"model": getattr(
        configs, MODELS[cell.split(".")[0]])(feat=32, stacked=1)}
    mix = dict(files["mix"], batch=2, canvas=[128, 192],
               img_scale=[192, 128], pool_batches=4, orig_long=[160, 200])
    if mix["entry"] == "detect":
        mix["dtype"] = "float32"
    else:
        mix["mixed_precision"] = False
    files["mix"] = mix
    return files


def run(cell, fault=None):
    files = tiny(cell)
    # long enough that a loaded CPU still finishes a few batches
    seconds = 8.0 if files["mix"]["entry"] == "train" else 3.0
    return run_cell(files, 2 ** 31 + 17, seconds, False, "cpu", fault,
                    out=io.StringIO())


@pytest.mark.parametrize("cell", CELLS["detect"] + CELLS["train"])
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS["detect"])
@pytest.mark.parametrize("fault", ("shift", "half"))
def test_detect_fault_is_caught(cell, fault):
    assert not run(cell, fault)["correct"]


@pytest.mark.parametrize("cell", CELLS["train"])
@pytest.mark.parametrize("fault", ("frozen", "half"))
def test_train_fault_is_caught(cell, fault):
    assert not run(cell, fault)["correct"]


@pytest.mark.parametrize("cell", CELLS["detect"] + CELLS["train"])
def test_control_is_caught(cell):
    """The reference rounded to fp8 in the program's place fails one of
    the cell's numbers."""
    from h100bench.run import entry_class
    files = tiny(cell)
    entry = entry_class(files["mix"]["entry"])(files, 23, "cpu")
    entry.setup()
    entry.window(0.5, False)
    entry.release()
    numbers = entry.control_numbers("fp8")
    ok, _ = harness.judge(numbers, files["limits"])
    assert not ok, numbers
