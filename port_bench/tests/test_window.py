"""The window's arithmetic: every metric reader on a record made by
hand."""
import pytest

from port_bench import harness, trace


def rec(**kw):
    r = {"n_pixels": 1000, "spp_per_pass": 1, "setup_s": 3.0,
         "scene_load_s": 0.5, "pass_s": [i / 1000 for i in range(1, 101)],
         "window_s": 5.05, "trace": None}
    r.update(kw)
    return r


def read(name, r):
    return harness.reader(name)(r)


def test_rate_is_all_samples_over_all_window_time():
    # 100 passes of 1,000 pixels in 5.05 s
    assert read("msamples_per_s", rec()) == pytest.approx(
        100 * 1000 / 5.05 / 1e6)


def test_p95_is_over_every_pass():
    # passes of 1..100 ms: the 95th percentile by linear interpolation
    assert read("pass_ms_p95", rec()) == pytest.approx(95.05)
    assert read("pass_ms_p95", rec(pass_s=[0.5] * 19 + [2.0])) \
        == pytest.approx(575.0)


def test_set_up_readers():
    assert read("setup_s", rec()) == 3.0
    assert read("scene_load_s", rec()) == 0.5


def test_trace_readers_are_silent_without_a_trace():
    for name in ("walk_host_ms_per_spp", "rng_device_ms_per_spp",
                 "own_kernel_device_ms_per_spp", "own_kernel_roofline",
                 "device_idle_share", "launches_per_spp"):
        assert read(name, rec()) is None


def test_trace_readers():
    t = {"passes": 4, "window_s": 0.8, "busy_s": 0.1, "launches": 400,
         "own_device_s": 0.002, "own_bound_ms": 0.5, "own_matched_ms": 2.0,
         "layer": {"bounce loop": {"host_ms": 200.0, "device_ms": 90.0},
                   "rng.lane_uniform": {"host_ms": 20.0, "device_ms": 60.0}}}
    r = rec(trace=t, pass_s=[0.1] * 10, window_s=1.0)
    assert read("walk_host_ms_per_spp", r) == pytest.approx(50.0)
    assert read("rng_device_ms_per_spp", r) == pytest.approx(15.0)
    assert read("own_kernel_device_ms_per_spp", r) == pytest.approx(0.5)
    assert read("own_kernel_roofline", r) == pytest.approx(25.0)
    assert read("launches_per_spp", r) == pytest.approx(100.0)
    # 25 ms busy a pass against 100 ms an untraced pass
    assert read("device_idle_share", r) == pytest.approx(75.0)
    t["own_bound_ms"] = None       # a launch left unmatched: no roofline
    assert read("own_kernel_roofline", r) is None


def test_union_of_kernel_intervals():
    total, gaps = trace._union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert total == 4
    assert gaps == [(3, 5)]


def test_compare_counts_channels_off_by_more_than_the_tolerance():
    import torch
    ref = torch.ones(10, 3)
    prog = ref.clone()
    assert harness.compare(prog, ref) == {"mismatch_share": 0.0,
                                          "max_gap": 0.0}
    prog[0, 1] = 1.5
    prog[1, 2] = 1.00001           # within 1e-4 of its value
    got = harness.compare(prog, ref)
    assert got["mismatch_share"] == pytest.approx(1 / 30)
    assert got["max_gap"] == pytest.approx(0.5)
    prog[2, 0] = float("nan")
    assert harness.compare(prog, ref)["mismatch_share"] == 1.0


def test_pixels_are_drawn_from_the_seed():
    a = harness.sample_pixels(2 ** 31 + 5, 1000, 50)
    assert (a == harness.sample_pixels(2 ** 31 + 5, 1000, 50)).all()
    assert len(set(a.tolist())) == 50
    assert not (a == harness.sample_pixels(6, 1000, 50)).all()
