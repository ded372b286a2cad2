"""BENCHMARK.json against the contract's shape, and the files the harness
finds by name."""
import json
import re
import time

from port_bench import harness

from .common import tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# what a traffic driver exposes (drivers/pt.py)
DRIVER = ("make", "step", "film", "reference_scene", "reference", "ranges")

# a second integrator: each pass adds a value drawn from (seed, pass,
# pixel, channel), which its reference sums in closed form
DUMMY = """
import torch
from port_bench.reference import scene as ref_scene


class Flat:
    def __init__(self, w, h, seed):
        self.color = torch.zeros(w, h, 3)
        self.seed, self.cnt = seed, 0


def _pass(seed, cnt, pix):
    return ((pix[:, None] * 3 + torch.arange(3)) % 7 + seed % 5
            + cnt).float()


def make(scene, cfg, seed, traffic):
    return Flat(cfg.w, cfg.h, seed)


def step(r):
    r.cnt += 1
    pix = torch.arange(r.color.numel() // 3)
    r.color += _pass(r.seed, r.cnt, pix).reshape(r.color.shape)


def film(r):
    return r.color


def reference_scene(xml, overrides):
    return ref_scene.load(str(xml), overrides)


def reference(sc, seed, passes, pix, dtype=torch.float32):
    return sum(_pass(seed, c, pix) for c in range(1, passes + 1)).float()


def ranges():
    return ()
"""


def test_manifest_keys_and_names():
    b = harness.manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    metrics = b["end_to_end"] + b["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])


def test_every_name_has_its_files():
    b = harness.manifest()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert (harness.ROOT / conf["scene"]).exists()
        assert set(c["reduced"]) == set(conf["reduced"])
    for w in b["workloads"]:
        entry, _conf, traffic, limits = harness.cell(b, w["name"])
        drv = harness.driver(traffic)
        assert all(callable(getattr(drv, f)) for f in DRIVER)
        assert {"sample_pixels", "mismatch_share"} <= set(limits)
        assert set(limits) <= {"sample_pixels", "mismatch_share", "max_gap"}
        for kind in ("end_to_end", "per_layer"):
            for m in harness.metric_names(b, w["name"], kind):
                assert callable(harness.reader(m))


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new configuration, traffic mix, cell, limits file and metrics,
    written as new files and manifest entries only, are found, run and
    reported."""
    bench, base = tiny_bench(tmp_path)
    traffic = json.loads((base / "traffic" / "pt.json").read_text())
    traffic["warmup_passes"] = 2
    (base / "traffic" / "pt2.json").write_text(json.dumps(traffic))
    (base / "limits" / "cbox-pt2.json").write_text(
        (base / "limits" / "cbox-pt.json").read_text())
    (base / "metrics" / "passes_in_window.py").write_text(
        "def read(rec):\n    return len(rec['pass_s'])\n")
    bench["workloads"].append({"name": "cbox-pt2", "config": "cbox",
                               "traffic": "pt2", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "passes_in_window", "unit": "passes",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["cbox-pt2"]})
    conf = json.loads((base / "configs" / "cbox.json").read_text())
    conf["overrides"]["max_bounce"] = 6
    (base / "configs" / "cbox6.json").write_text(json.dumps(conf))
    bench["configs"].append(dict(bench["configs"][0], name="cbox6",
                                 file=str(base / "configs" / "cbox6.json")))
    bench["workloads"][-1]["config"] = "cbox6"
    (base / "metrics" / "film_pixels.py").write_text(
        "def read(rec):\n    return rec['n_pixels']\n")
    bench["per_layer"].append({"name": "film_pixels", "unit": "pixels",
                               "better": "higher", "source": "host_clock",
                               "layer": "film", "moves": "msamples_per_s",
                               "workloads": ["cbox-pt2"]})
    assert harness.metric_names(bench, "cbox-pt2", "per_layer")[-1] \
        == "film_pixels"
    assert harness.read_metrics(bench, ["film_pixels"], {"n_pixels": 480},
                                base)["film_pixels"]["value"] == 480
    res = harness.run("cbox-pt2", 5, 0.2, 0, time.perf_counter(),
                      device="cpu", bench=bench, base=base)
    assert res["correct"]
    assert res["metrics"]["passes_in_window"]["value"] == res["attempted"]
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s",
                                   "passes_in_window"}


def test_a_traffic_mix_with_a_driver_of_its_own_is_added_by_files_alone(
        tmp_path):
    """Another integrator arrives as a driver file, a traffic file naming
    it, a limits file and a cell entry: the harness runs it and judges its
    film by the driver's reference."""
    bench, base = tiny_bench(tmp_path)
    (base / "drivers" / "flat.py").write_text(DUMMY)
    (base / "traffic" / "flat.json").write_text(json.dumps(
        {"driver": "flat", "spp_per_pass": 1, "warmup_passes": 1,
         "traced_passes": 2}))
    (base / "limits" / "cbox-flat.json").write_text(json.dumps(
        {"sample_pixels": 64, "mismatch_share": 0.0, "max_gap": 0.0}))
    bench["workloads"].append({"name": "cbox-flat", "config": "cbox",
                               "traffic": "flat", "chips": 1, "why": "test"})
    res = harness.run("cbox-flat", 2 ** 31 + 3, 0.2, 0, time.perf_counter(),
                      device="cpu", bench=bench, base=base)
    assert res["correct"], res["checks"]
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    assert res["attempted"] >= 1

    def skip_a_pass(r):
        r.cnt += 1                 # the film misses the first pass
        return r
    res = harness.run("cbox-flat", 2 ** 31 + 3, 0.2, 0, time.perf_counter(),
                      device="cpu", bench=bench, base=base,
                      renderer_hook=skip_a_pass)
    assert not res["correct"], res["checks"]
