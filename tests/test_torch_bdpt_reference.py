"""The port's BDPT against the benchmark's plain BDPT reference
(port_bench/reference/bdpt.py, which imports neither JAX nor the port) on
trans/cbox-point.xml at 16x16, 3 bounces and 8 time bins of 4.0 from 8.0:
the transient histogram entry by entry, in the flat form and in the scan
form (`FLAT_MAX_CHUNKS` = 0: every group strategy by strategy, as the
connection group runs at 512^2), and the steady-state film of the same
scene. And the module-level binning (`bin_transient`) against histograms
written by the binning closure it replaced (tests/goldens/
trans_bdpt_bins_16.npz: 2 passes, seed 1234567, flat and scan form), bit
for bit."""
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from adapt_tpu_torch.renderer import bdpt
from adapt_tpu_torch.scene.compile import load_scene
from port_bench.reference import bdpt as ref_bdpt

ROOT = Path(__file__).resolve().parents[1]
SCENES = ROOT / "port_bench" / "scenes"
GOLDEN = ROOT / "tests" / "goldens" / "trans_bdpt_bins_16.npz"
SEED = 2 ** 31 - 987654321
# the reference's MIS weights sum the ratio sweeps in a loop where the
# port factors them into prefix tables (bdpt.py `_sweep_table`), and the
# steady film sums the strategies in another order: a few float32 ulps an
# entry (at most 2.2e-7 of an entry over four seeds, both forms and the
# steady film; entries that hold no light are 0 in both)
RTOL = 2e-6


def toy_scene(tmp, steady=False):
    """port_bench's frozen trans/cbox-point.xml at 16x16, 3 bounces, 8
    bins of 4.0 (8.0 to 40.0: the box's paths of 2-4 segments), beside a
    copy of its meshes; steady: without its decomposition."""
    shutil.copytree(SCENES / "meshes", tmp / "meshes", dirs_exist_ok=True)
    (tmp / "trans").mkdir(exist_ok=True)
    xml = (SCENES / "trans" / "cbox-point.xml").read_text()
    for name, value in (("width", 16), ("height", 16), ("max_bounce", 3),
                        ("sample_count", 8), ("interval", "4.0")):
        xml = re.sub(rf'name="{name}" value="[^"]*"',
                     f'name="{name}" value="{value}"', xml)
    if steady:
        xml = re.sub(r'<string name="decomposition"[^>]*>', "", xml)
    path = tmp / "trans" / "cbox-point.xml"
    path.write_text(xml)
    return path


def _render(xml, passes, seed):
    scene, cfg, _ = load_scene(str(xml.parent), xml.name, device="cpu")
    r = bdpt.BDPT(scene, cfg, seed=seed)
    for _ in range(passes):
        r.render()
    return r


def _close(prog, ref):
    diff = (prog.double() - ref.double()).abs()
    return bool((diff <= RTOL * ref.double().abs()).all())


@pytest.mark.parametrize("flat_max_chunks", [bdpt.FLAT_MAX_CHUNKS, 0])
def test_reference_histogram_equals_the_program(tmp_path, monkeypatch,
                                                flat_max_chunks):
    monkeypatch.setattr(bdpt, "FLAT_MAX_CHUNKS", flat_max_chunks)
    xml = toy_scene(tmp_path)
    r = _render(xml, 2, SEED)
    assert r.is_transient and r.cfg.t_bins == 8 and r.cfg.t_min == 8.0
    # the connection group's 3 strategies: one chunk, scanned or not
    assert bdpt.scan_form(3, r.cfg.n_pixels) == (flat_max_chunks == 0)
    cell = ref_bdpt.load(str(xml), {})
    assert (cell.w, cell.h) == (256, 8)
    ref = ref_bdpt.film(cell, SEED, 2, torch.arange(cell.w * cell.h))
    prog = r.time_bins.reshape(-1, 3)
    # the same entries hold light (no time fell into another bin), and
    # enough of them for the comparison to mean something
    assert torch.equal(prog > 0, ref > 0)
    assert 0.15 < float((ref.amax(dim=-1) > 0).double().mean()) < 0.9
    assert _close(prog, ref)


def test_reference_film_equals_the_program_steady(tmp_path):
    xml = toy_scene(tmp_path, steady=True)
    r = _render(xml, 2, SEED)
    assert not r.is_transient
    cell = ref_bdpt.load(str(xml), {})
    assert (cell.bins, cell.w, cell.h) == (0, 16, 16)
    ref = ref_bdpt.film(cell, SEED, 2, torch.arange(256))
    prog = r.color.reshape(-1, 3)
    assert float(ref.mean()) > 0.5
    assert _close(prog, ref)


@pytest.mark.parametrize("flat_max_chunks", [bdpt.FLAT_MAX_CHUNKS, 0])
def test_lifted_binning_keeps_the_bins(tmp_path, monkeypatch,
                                       flat_max_chunks):
    monkeypatch.setattr(bdpt, "FLAT_MAX_CHUNKS", flat_max_chunks)
    r = _render(toy_scene(tmp_path), 2, 1234567)
    gold = np.load(GOLDEN)
    key = "4" if flat_max_chunks else "0"
    assert np.array_equal(r.time_bins.numpy(), gold[f"bins_{key}"])
    assert np.array_equal(r.time_cnts.numpy(), gold[f"cnts_{key}"])


def test_the_reference_refuses_what_it_cannot_render(tmp_path):
    xml = toy_scene(tmp_path)
    text = xml.read_text()
    for old, new, what in (
            ('value="transient_cam"', 'value="transient_lit"',
             "decomposition"),
            ('type="transparent"', 'type="hg"', "world medium"),
            ('type="lambertian" id="box"', 'type="fresnel-blend" id="box"',
             "lambertian")):
        xml.write_text(text.replace(old, new))
        with pytest.raises(NotImplementedError, match=what):
            ref_bdpt.load(str(xml), {})
    xml.write_text(text.replace('name="width" value="16"/>',
                                'name="width" value="16"/><integer '
                                'name="crop_rx" value="2"/><integer '
                                'name="crop_ry" value="2"/>'))
    with pytest.raises(NotImplementedError, match="crop"):
        ref_bdpt.load(str(xml), {})
