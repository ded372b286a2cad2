"""What the benchmark's processes load, by whole top-level module names
(adapt_tpu_torch begins with adapt_tpu, so a prefix test would be
wrong)."""
import json
import subprocess
import sys

from port_bench import harness

ROOT = str(harness.ROOT)


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax(tmp_path):
    """The control runs the driver's reference side alone: the reference
    scene, the sampled pixels and two films."""
    mods = _loaded(
        "import sys\nsys.path.insert(0, '.')\nfrom pathlib import Path\n"
        "from port_bench import control\n"
        "from port_bench.tests.common import tiny_bench\n"
        f"bench, base = tiny_bench(Path({str(tmp_path)!r}))\n"
        "control.numbers('cbox-pt', 77, 2, 'cpu', bench, base)\n")
    assert "port_bench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "adapt_tpu",
                       "adapt_tpu_torch"}, mods


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    code = (
        "import sys, time\nsys.path.insert(0, 'port_bench/tests')\n"
        "sys.path.insert(0, '.')\nfrom pathlib import Path\n"
        "from port_bench import harness, run, trace\n"
        "from port_bench.tests.common import tiny_bench\n"
        f"bench, base = tiny_bench(Path({str(tmp_path)!r}))\n"
        "res = harness.run('cbox-pt', 3, 0.1, 0, time.perf_counter(),"
        " device='cpu', bench=bench, base=base)\nassert res['correct']\n")
    mods = _loaded(code)
    assert "adapt_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN), mods


def test_run_exits_without_a_card():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "cbox-pt",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": "/nonexistent", "PYTHONPATH": ""})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""


def test_a_run_that_loads_jax_after_the_window_gives_no_result(tmp_path):
    """A metric reader (run after the window and the check) that imports
    a module named jax makes the run refuse: the look at sys.modules comes
    last."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(tmp_path / 'stub')!r})\n"
        "sys.path.insert(0, '.')\nfrom pathlib import Path\n"
        "from port_bench import harness\n"
        "from port_bench.tests.common import tiny_bench\n"
        f"bench, base = tiny_bench(Path({str(tmp_path)!r}))\n"
        "(base / 'metrics' / 'planted.py').write_text("
        "'import jax\\ndef read(rec):\\n    return 1.0\\n')\n"
        "bench['end_to_end'].append({'name': 'planted', 'unit': 'x',"
        " 'better': 'lower', 'bound': 0.1, 'source': 'host_clock'})\n"
        "assert 'jax' not in sys.modules\n"
        "try:\n"
        "    harness.run('cbox-pt', 3, 0.1, 0, time.perf_counter(),"
        " device='cpu', bench=bench, base=base)\n"
        "except harness.Refused as err:\n"
        "    print('REFUSED', err)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REFUSED loaded forbidden modules: jax" in out.stdout, out.stdout
