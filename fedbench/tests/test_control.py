"""The control and the faults fail a cell's limits: the reference put in
the program's place in TF32 (the precision below the configuration's),
half of every batch left out, the exchange between clients left out. On
the card at test sizes; ``fedbench/control.py`` reads the same at the
cells' own sizes."""

import json
from pathlib import Path

import pytest
import torch

from fedbench import control

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail_the_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedbench import run

    limits = run.load_cell(workload)["limits"]
    recs = control.calibrate(workload, [101], [101], device="cuda",
                             test_sizes=True)
    by = {r["reading"]: r["gaps"] for r in recs}

    def fails(gaps):
        return any(gaps[k] > lim for k, lim in limits.items())

    assert not fails(by["program"]), by["program"]
    for reading in ("control:tf32", "fault:half_batch", "fault:no_exchange",
                    "fault:unchanged"):
        assert fails(by[reading]), (reading, by[reading])
