"""On the card: a short run of each cell is correct, and the control is
not. Run there with

    python3 -m pytest port_bench/tests -m cuda -q
"""
import json
import subprocess
import sys

import pytest

from port_bench import control, harness


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]])
def test_a_short_run_is_correct(workload):
    _card()
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 11), "--seconds", "5", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]])
def test_the_control_fails_on_the_card(workload):
    _card()
    got, limits = control.numbers(workload, 2 ** 31 + 12, 20, "cuda")
    assert any(got[k] > limits[k] for k in got), got
