"""The port's CLI, `python -m adapt_tpu_torch.render`, end to end on the CPU.

Each run is a subprocess with `--arch cpu` at 32^2, 3 bounces:

* an image and a checkpoint written; `-l` resumes and continues the count;
* `--profile` writes the chrome trace, with the program's spans as
  ranges, and program.json (adapt_tpu_torch/obs.py's export);
* the transient export with `--analyze` on trans/cbox-point.xml (one
  frame per time bin, frames.npy, the time-domain curve);
* PT on trans/foam.xml (null BSDFs): one pass, image and film;
* `--serve` answers with the preview's PNG while it renders and, with
  ADAPT_SERVE_AFTER=0, exits when the render is done;
* config-file boolean flags (parsers/opts.py, in process);
* `--multichip 2`: two gloo ranks render, rank 0 prints the mesh and
  writes the image and checkpoint, whose film equals the one-process
  passes of the two shards; `--multichip` refuses --type ao; `--arch
  cuda` without a card exits non-zero without rendering;
* the film of cbox at 32^2, 2 spp, seed 0 equals render.py's (the JAX
  package's CLI, `--arch cpu`, the same flags) under the goldens' `_check`
  bound, compared on the checkpoints' accumulated films, not the 8-bit
  images.
"""
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from adapt_tpu_torch.parsers.opts import get_options

from test_torch_pt import _close

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = ["--width", "32", "--height", "32", "--max_bounce", "3",
         "--no_watermark"]


def _cmd(args, tmp, port=True):
    """The port's CLI (port) or render.py (not port) on the CPU."""
    head = [sys.executable, "-m", "adapt_tpu_torch.render"] if port \
        else [sys.executable, os.path.join(REPO, "render.py")]
    return head + ["--input_path", os.path.join(REPO, "scenes"),
                   "--output_path", os.path.join(tmp, "out"),
                   "--arch", "cpu"] + SMALL + args


def _env(**kw):
    # two intra-op threads: a 32^2 render needs no more, and the suite's
    # workers share the machine's cores
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    env.update(kw)
    return env


def _run(args, tmp, port=True, timeout=240):
    return subprocess.run(_cmd(args, tmp, port), cwd=tmp, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _checkpoint(tmp, name):
    with open(os.path.join(tmp, "checkpoint", name), "rb") as f:
        return pickle.load(f)


def test_cli_render_checkpoint_resume(tmp_path):
    tmp = str(tmp_path)
    args = ["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
            "--iter_num", "2", "--img_name", "smoke"]
    p = _run(args, tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "device=cpu" in p.stdout and "done: 2 spp" in p.stdout, p.stdout
    assert os.path.exists(os.path.join(tmp, "out", "smoke.png"))
    ck = "smoke-cbox-pt-32x32.pkl"
    assert _checkpoint(tmp, ck)["counter"] == 2
    p = _run(args + ["-l"], tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "resumed from checkpoint at 2 iterations" in p.stdout
    assert _checkpoint(tmp, ck)["counter"] == 4


def test_cli_profile_writes_program_spans(tmp_path):
    """--profile: the chrome trace carries the program's span names as
    ranges, and program.json holds the spans and counters of the pass."""
    import json
    tmp = str(tmp_path)
    p = _run(["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
              "--iter_num", "1", "--img_name", "prof", "--profile"], tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    with open(os.path.join(tmp, "profiler_trace", "program.json")) as f:
        rec = json.load(f)
    names = [s["name"] for s in rec["spans"]]
    assert names.count("render.pass") == 1 and names.count("pt.bounce") == 3
    assert "setup.scene" in names
    assert rec["counters"]["lanes.issued"] == 3 * 32 * 32
    with open(os.path.join(tmp, "profiler_trace", "trace.json")) as f:
        trace = f.read()
    assert '"pt.bounce"' in trace and '"rng.draw"' in trace


def test_cli_transient_analyze(tmp_path):
    tmp = str(tmp_path)
    p = _run(["--scene", "trans", "--name", "cbox-point.xml", "--type",
              "bdpt", "--iter_num", "1", "--img_name", "tr", "--analyze"],
             tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    tdir = os.path.join(tmp, "out", "trans-transient")
    frames = np.load(os.path.join(tdir, "frames.npy"))
    assert frames.shape == (400, 32, 32, 3) and np.isfinite(frames).all()
    assert len([f for f in os.listdir(tdir) if f.endswith(".png")]) >= 400
    assert os.path.exists(os.path.join(tdir, "tdom_curve.npy"))
    assert "transient profile: 400 frames" in p.stdout


def test_cli_pt_on_null_bsdfs(tmp_path):
    """`--type pt` renders trans/foam.xml (a null-BSDF foam of HG medium
    under a collimated light, which contributes nothing under PT with
    MIS, as in the JAX package): one pass, its image and a finite film."""
    tmp = str(tmp_path)
    p = _run(["--scene", "trans", "--name", "foam.xml", "--type", "pt",
              "--iter_num", "1", "--img_name", "foam"], tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "renderer=pt" in p.stdout and "done: 1 spp" in p.stdout, p.stdout
    assert os.path.exists(os.path.join(tmp, "out", "foam.png"))
    film = np.asarray(_checkpoint(tmp, "foam-trans-pt-32x32.pkl")[
        "accumulation"])
    assert film.shape == (32, 32, 3) and np.isfinite(film).all()


def test_cli_serve_preview(tmp_path):
    """The preview answers while the render runs; ADAPT_SERVE_AFTER=0
    ends the process when the render is done."""
    tmp = str(tmp_path)
    proc = subprocess.Popen(
        _cmd(["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
              "--iter_num", "16", "--serve", "0"], tmp),
        cwd=tmp, env=_env(ADAPT_SERVE_AFTER="0"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        for line in proc.stdout:
            lines.append(line)
            if "live preview: http" in line:
                port = int(line.rsplit(":", 1)[1].strip().rstrip("/"))
                break
        assert port, "".join(lines)
        # keep draining stdout, or the render blocks on a full pipe
        drain = threading.Thread(target=lambda: lines.extend(proc.stdout),
                                 daemon=True)
        drain.start()
        png, last_err = None, None
        for _ in range(240):
            if proc.poll() is not None:
                break
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/frame.png", timeout=2) as r:
                    png = r.read()
                if png[:4] == b"\x89PNG":
                    break
            except OSError as e:        # no frame published yet
                last_err = e
            time.sleep(0.25)
        assert png and png[:4] == b"\x89PNG", (png, last_err, proc.poll())
        assert proc.wait(timeout=240) == 0
        drain.join(timeout=30)
        assert any("done: 16 spp" in ln for ln in lines), "".join(lines)
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)


def test_config_file_boolean_flags(tmp_path):
    """'flag = true/false' lines for store_true flags, values for the
    others; flags on the command line win."""
    cfgf = tmp_path / "r.conf"
    cfgf.write_text("debug = true\nno_watermark = false\n"
                    "iter_num = 7\nscene = vpt\narch = cpu\n")
    opts = get_options(["--config", str(cfgf)])
    assert opts.debug is True and opts.no_watermark is False
    assert opts.iter_num == 7 and opts.scene == "vpt" and opts.arch == "cpu"
    assert get_options(["--config", str(cfgf), "--iter_num", "9"]).iter_num \
        == 9
    assert get_options([]).arch == "cuda"          # the card by default
    bad = tmp_path / "bad.conf"
    bad.write_text("debug = maybe\n")
    with pytest.raises(SystemExit):
        get_options(["--config", str(bad)])


def test_cli_multichip(tmp_path):
    """--multichip 2 on the CPU: a 1 x 2 mesh of gloo ranks; the image and
    the checkpoint are rank 0's, and the film is the two 'px' shards'
    one-process passes (renderer/pt.py trace_pt, the JAX package's keys
    of each shard) accumulated over the CLI's two passes, exactly."""
    import dataclasses
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.renderer.pt import trace_pt
    from adapt_tpu_torch.scene.compile import load_scene
    from test_torch_ranks import shard_film
    tmp = str(tmp_path)
    p = _run(["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
              "--multichip", "2", "--iter_num", "2", "--img_name", "mc"],
             tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "multichip mesh: {'spp': 1, 'px': 2} over 2 devices" in p.stdout
    assert p.stdout.count("done: 2 spp") == 1, p.stdout
    assert os.path.exists(os.path.join(tmp, "out", "mc.png"))
    chk = _checkpoint(tmp, "mc-cbox-pt-32x32.pkl")
    assert chk["renderer"] == "MultiChip-trace_pt" and chk["counter"] == 2
    scene, cfg, _ = load_scene(os.path.join(REPO, "scenes", "cbox"),
                               "cbox.xml", device="cpu")
    cfg = dataclasses.replace(cfg, w=32, h=32, focal=cfg.focal * 32 / 512,
                              end_x=32, end_y=32, max_bounce=3)
    key, film = rng.PRNGKey(0), torch.zeros((cfg.n_pixels, 3))
    for cnt in (1, 2):
        key, sub = rng.split(key)
        film = film + shard_film(scene, cfg, sub, 1, 2, trace_pt, cnt)
    np.testing.assert_array_equal(chk["accumulation"], film.numpy())


def test_cli_refusals(tmp_path):
    """--multichip takes pt, vpt and bdpt only; --arch cuda without a
    card exits non-zero and writes no image."""
    tmp = str(tmp_path)
    p = _run(["--multichip", "2", "--type", "ao", "--iter_num", "1"], tmp)
    assert p.returncode != 0 and "--multichip supports pt/vpt/bdpt" \
        in p.stderr, p.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --arch cuda renders on it")
    cmd = [a if a != "cpu" else "cuda" for a in _cmd(
        ["--iter_num", "1", "--img_name", "nocard"], tmp)]
    p = subprocess.run(cmd, cwd=tmp, env=_env(), capture_output=True,
                       text=True, timeout=240)
    assert p.returncode != 0 and "torch.cuda.is_available()" in p.stderr
    assert not os.path.exists(os.path.join(tmp, "out", "nocard.png"))


def test_cli_film_matches_render_py(tmp_path):
    """cbox at 32^2, 3 bounces, 2 spp, seed 0: the port CLI's accumulated
    film against render.py's (the JAX package on the CPU)."""
    tmp = str(tmp_path)
    args = ["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
            "--iter_num", "2", "--seed", "0", "--no_save_fig"]
    p = _run(args + ["--img_name", "port"], tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    j = _run(args + ["--img_name", "jax"], tmp, port=False, timeout=600)
    assert j.returncode == 0, j.stderr[-2000:]
    got = _checkpoint(tmp, "port-cbox-pt-32x32.pkl")
    want = _checkpoint(tmp, "jax-cbox-pt-32x32.pkl")
    assert got["counter"] == int(np.asarray(want["counter"])) == 2
    film, ref = (np.asarray(c["accumulation"]) / 2 for c in (got, want))
    assert film.shape == ref.shape == (32, 32, 3)
    _close(film, ref)
    assert film.mean() > 0.05


def test_multichip_refuses_more_nccl_ranks_than_cards(monkeypatch):
    """NCCL takes one rank a card: `--multichip N --arch cuda` with N above
    the visible cards exits with a message before it starts a rank, and
    init_ranks (the torchrun path) refuses such a world (the card count
    and NCCL faked here, where there is no card)."""
    from adapt_tpu_torch import render as R
    from adapt_tpu_torch.parallel import sharding
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sharding.dist, "is_nccl_available", lambda: True)
    started = []
    monkeypatch.setattr(sharding, "run_ranks",
                        lambda *a, **k: started.append(a))
    with pytest.raises(SystemExit, match="one rank a card"):
        R.main(["--multichip", "2", "--arch", "cuda", "--type", "pt"])
    assert not started
    with pytest.raises(RuntimeError, match="one rank a card"):
        sharding.init_ranks(0, 2, sharding.free_port(), "cuda")
