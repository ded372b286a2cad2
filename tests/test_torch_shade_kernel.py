"""The shading kernels (csrc/shade.cu through ops/shade_kernels.py) and
the route bxdf_ops.py's `surface_eval`, `surface_sample` and
`surface_pdf` take to them.

* On the CPU: `shade_kernels.route` sends CPU tensors to the plain
  version (`surface_*_plain`, same values) and counts `shade.eager`. With
  the card test stubbed true and each launch stubbed by the plain
  version's base result, a call whose inputs need a gradient takes the
  kernel route (`shade.kernel`), and its gradients equal the plain
  route's (`_Replay`'s backward; first order bit for bit, second order
  to the last bits); under no_grad the launch is plain.
* Marked `cuda` (skipped without a card; this file imports no JAX, so
  `python -m pytest --noconftest tests/test_torch_shade_kernel.py` runs
  them on the card): every arm x {eval, sample, pdf} x transport
  modes x two-sided on/off x textured/untextured k_d, held to the plain
  version on the card bit for bit (`is_specular` exactly; NaN where the
  plain version gives NaN). Each wavefront carries dead lanes (obj_id -1,
  the (1, 0, 0) normals a miss leaves), grazing and normal-incidence
  directions, shading normals along +-y (the rotations' parallel
  fallback), and uniforms read through a row stride as PT's
  `u_all[:, 1:7]`. Then a mixed wavefront of every arm with lanes of a
  kind the scene lacks (mixture rows: the defaults), scenes with no BRDF or
  no BSDF arm, gradients through the kernels equal to the plain
  version's, a scene listing a tag the kernels do not know refused, and
  whole renders (PT on cbox, balls-multi and a BxDF
  mixture of a lambertian, a GGX and a glass component, BDPT on cbox and
  the mixture and balls-multi, VPT on the vpt cbox and the mixture) equal
  to the renders the plain version gives.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from adapt_tpu_torch import obs
from adapt_tpu_torch.constants import (BRDFTag, BSDFTag, TRANSPORT_IMP,
                                       TRANSPORT_RAD, TRANSPORT_UNI)
from adapt_tpu_torch.ops import _build, bxdf_ops, shade_kernels
from adapt_tpu_torch.ops.intersect import Interaction
from adapt_tpu_torch.scene.compile import load_scene

SCENE_DIR = os.path.join(os.path.dirname(__file__), "..", "scenes")
N = 4096
MODES = {"uni": TRANSPORT_UNI, "rad": TRANSPORT_RAD, "imp": TRANSPORT_IMP}
# (is_bsdf, tag) of every arm bxdf_ops.py has (a mixture's lanes are
# overlaid, never dispatched)
ARMS = [(False, t) for t in range(BRDFTag.THIN_COAT + 1)] \
    + [(True, t) for t in (BSDFTag.NULL, BSDFTag.DET_REFRACTION,
                           BSDFTag.LAMBERTIAN)]
ARM_IDS = [("bsdf" if b else "brdf") + str(t) for b, t in ARMS]


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _f32(x):
    return np.ascontiguousarray(x, dtype=np.float32)


def _params(g, kind, is_bsdf, n):
    """Per-lane material parameters of one tag, as the scene compiler
    makes them, varied per lane."""
    kd = g.uniform(0.05, 0.95, (n, 3))
    ks = g.uniform(0.0, 0.4, (n, 3))
    kg = np.repeat(g.uniform(1.0, 60.0, (n, 1)), 3, 1)
    ior = np.ones(n)
    if is_bsdf:
        ior = g.choice([1.33, 1.5, 2.4], n)
    elif kind == BRDFTag.MICROFACET:
        kg = np.stack([g.uniform(0.02, 0.8, n), g.uniform(0.02, 0.8, n),
                       np.ones(n)], 1)
        ks = np.stack([np.ones(n), g.choice([1.33, 1.5, 2.0], n),
                       np.zeros(n)], 1)
    elif kind == BRDFTag.FRESNEL_BLEND:
        nu = np.where(np.arange(n) % 2, 10.0, g.uniform(1.0, 50.0, n))
        nv = np.where(np.arange(n) % 2, 1000.0, g.uniform(1.0, 50.0, n))
        kg = np.stack([nu, nv, np.sqrt((nu + 1) * (nv + 1)) / (8 * np.pi)],
                      1)
    elif kind in (BRDFTag.OREN_NAYAR, BRDFTag.THIN_COAT):
        sig = np.deg2rad(g.uniform(0.0, 40.0, n)) ** 2
        kg = np.stack([1.0 - sig / (2.0 * (sig + 0.33)),
                       0.45 * sig / (sig + 0.09),
                       g.choice([1.0, 1.5, 1.8], n)], 1)
    mean = np.stack([kd.mean(1), ks.mean(1), kg.mean(1)], 1)
    return dict(kind=np.full(n, kind, np.int32), is_bsdf=np.full(n, is_bsdf),
                kd=kd, ks=ks, kg=kg, mean=mean, ior=ior)


def wavefront(seed, arms, n=N, textured=False, extra_kinds=()):
    """(mat, it, incid, out, u) numpy dicts of one wavefront: lanes of the
    given (is_bsdf, tag) arms in no order, and of `extra_kinds` (BRDF tags
    the scene does not list, such as the mixture's rows)."""
    g = np.random.default_rng(seed)
    kinds = list(arms) + [(False, t) for t in extra_kinds]
    per = -(-n // len(kinds))
    rows = [_params(g, t, b, per) for b, t in kinds]
    mat = {k: np.concatenate([r[k] for r in rows])[:n] for k in rows[0]}
    perm = g.permutation(n)
    mat = {k: v[perm] for k, v in mat.items()}
    mat["is_delta"] = np.zeros(n, bool)
    mat["emit"] = np.full(n, -1, np.int32)

    n_s = _unit(g, n)
    n_g = n_s + 0.45 * _unit(g, n)
    n_g /= np.linalg.norm(n_g, axis=-1, keepdims=True)
    incid = _unit(g, n)
    out = _unit(g, n)
    # a quarter near the mirror direction, a tenth near the refracted one
    mirror = incid - 2 * np.sum(incid * n_s, -1, keepdims=True) * n_s
    near = g.uniform(size=(n, 1)) < 0.25
    out = np.where(near, mirror + 0.01 * _unit(g, n), out)
    out = np.where(g.uniform(size=(n, 1)) < 0.1,
                   incid + 0.005 * _unit(g, n), out)
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    lanes = np.arange(n)
    # grazing: the scattered direction in the tangent plane
    graze = lanes % 29 == 3
    t = np.cross(n_s[graze], _unit(g, int(graze.sum())))
    out[graze] = t / np.linalg.norm(t, axis=-1, keepdims=True)
    # normal incidence, and shading normals along +-y
    incid[lanes % 31 == 5] = -n_s[lanes % 31 == 5]
    n_s[lanes % 37 == 7] = [0.0, 1.0, 0.0]
    n_s[lanes % 37 == 8] = [0.0, -1.0, 0.0]
    obj = np.zeros(n, np.int32)
    # dead lanes: a miss's object id and normals
    dead = lanes % 23 == 1
    obj[dead] = -1
    n_s[dead] = n_g[dead] = [1.0, 0.0, 0.0]
    it = dict(obj_id=obj, n_s=n_s, n_g=n_g)
    if textured:
        tex = g.uniform(0.0, 1.0, (n, 3))
        tex[g.uniform(size=n) < 0.3] = -1.0     # untextured objects
        it["tex"] = tex
    # PT's draw: the lane's 11 uniforms, of which surface_sample reads 1:7
    u = g.uniform(size=(n, 11))
    return mat, it, incid, out, u


def on_device(arrays, dev):
    """The numpy wavefront as (MatParams, Interaction, incid, out, u) on
    dev; u is a (n, 6) view of rows of 11, as PT passes it."""
    mat, it, incid, out, u = arrays

    def t(x):
        x = torch.from_numpy(x if x.dtype in (np.int32, bool) else _f32(x))
        return x.to(dev)
    n = incid.shape[0]
    m = bxdf_ops.MatParams(**{k: t(v) for k, v in mat.items()})
    i = Interaction(obj_id=t(it["obj_id"]), prim_id=t(it["obj_id"]),
                    t=torch.ones(n, device=dev), n_g=t(it["n_g"]),
                    n_s=t(it["n_s"]), uv=torch.zeros((n, 2), device=dev),
                    tex=t(it["tex"]) if "tex" in it else None)
    return m, i, t(incid), t(out), t(u)[:, 1:7]


def cfg_of(arms, two_sides=False):
    return types.SimpleNamespace(
        brdf_types=tuple(sorted({t for b, t in arms if not b})),
        bsdf_types=tuple(sorted({t for b, t in arms if b})),
        brdf_two_sides=two_sides)


def call(name, route, cfg, mat, it, incid, out, u, w_ior, mode):
    """One surface call by name; route "plain" or "routed" (bxdf_ops's
    entry point)."""
    suffix = "_plain" if route == "plain" else ""
    fn = getattr(bxdf_ops, "surface_" + name + suffix)
    if name == "eval":
        return (fn(cfg, mat, it, incid, out, w_ior, mode),)
    if name == "sample":
        return fn(cfg, mat, it, incid, u, w_ior, mode)
    return (fn(cfg, mat, it, out, incid, w_ior),)


def assert_same(got, want):
    """Bit for bit: equal dtypes and shapes, equal bits or NaN in both."""
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
            continue
        same = (a.view(torch.int32) == b.view(torch.int32)) \
            | (torch.isnan(a) & torch.isnan(b))
        bad = (~same).nonzero()
        assert bad.numel() == 0, (
            f"{bad.shape[0]} of {a.numel()} differ, first at "
            f"{bad[0].tolist()}: {a[tuple(bad[0])]} vs {b[tuple(bad[0])]}")


def assert_grads(got, want, order):
    """First order bit for bit. The second backward sums the same terms
    along another graph (that of the plain version replayed in _Replay's
    backward), so the order of its sums may move the last bits: within
    1e-6 relative (of the largest entry, near zero)."""
    for a, b in zip(got, want, strict=True):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if order == 1:
            assert_same((a,), (b,))
        else:
            scale = float(b.nan_to_num().abs().max())
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * scale,
                                       equal_nan=True)


def _counters():
    c = obs.export()["counters"]
    return c["shade.kernel"], c["shade.eager"]


@pytest.fixture
def recorded():
    obs.reset()
    with obs.recording():
        yield
    obs.reset()


# ------------------------------- the route -------------------------------

@pytest.mark.parametrize("name", ["eval", "sample", "pdf"])
def test_cpu_tensors_take_the_plain_route(name, recorded):
    arms = ARMS
    mat, it, incid, out, u = on_device(wavefront(1, arms, n=512), "cpu")
    cfg = cfg_of(arms)
    w = torch.tensor(1.0)
    got = call(name, "routed", cfg, mat, it, incid, out, u, w, TRANSPORT_RAD)
    want = call(name, "plain", cfg, mat, it, incid, out, u, w, TRANSPORT_RAD)
    assert_same(got, want)
    assert _counters() == (0, 1)


def _stub_card(monkeypatch, name):
    """The card test stubbed true and the launch of `name` by the plain
    version's base result; returns the list of the stub's calls' grad
    modes."""
    monkeypatch.setattr(shade_kernels, "_on_card", lambda ts: True)
    ran = []

    def launch(*a):
        ran.append(torch.is_grad_enabled())
        with torch.no_grad():
            return shade_kernels._plain(name, *a)
    monkeypatch.setitem(shade_kernels._LAUNCH, name, launch)
    return ran


def _grad_inputs(seed):
    """A wavefront of every arm, two-sided, with k_d, k_s, k_g, ior, the
    shading normals, both directions and the world's ior as leaves that
    need a gradient; u is the (n, 6) view PT passes."""
    mat, it, incid, out, u = on_device(wavefront(seed, ARMS, n=256), "cpu")
    mat = dataclasses.replace(
        mat, **{k: getattr(mat, k).requires_grad_(True)
                for k in ("kd", "ks", "kg", "ior")})
    it = dataclasses.replace(it, n_s=it.n_s.requires_grad_(True))
    incid.requires_grad_(True)
    out.requires_grad_(True)
    w = torch.tensor(1.33, requires_grad=True)
    return mat, it, incid, out, u, w


def _leaves(mat, it, incid, out, w):
    return [mat.kd, mat.ks, mat.kg, mat.ior, it.n_s, incid, out, w]


def _fresh(inputs):
    """The inputs with fresh leaves (same values, no grads yet)."""
    mat, it, incid, out, u, w = inputs
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    return (dataclasses.replace(mat, kd=leaf(mat.kd), ks=leaf(mat.ks),
                                kg=leaf(mat.kg), ior=leaf(mat.ior)),
            dataclasses.replace(it, n_s=leaf(it.n_s)), leaf(incid),
            leaf(out), u, leaf(w))


def _grads(name, route, inputs, order):
    """(outputs, the leaves' gradients) of a weighted sum of the call's
    float outputs; order 2: of the weighted sum of its gradient along the
    arriving direction."""
    mat, it, incid, out, u, w = _fresh(inputs)
    cfg = cfg_of(ARMS, two_sides=True)
    res = call(name, route, cfg, mat, it, incid, out, u, w, TRANSPORT_RAD)
    g = torch.Generator().manual_seed(11)
    weights = lambda t: torch.rand(t.shape, generator=g).to(t.device)
    loss = sum((r * weights(r)).sum() for r in res if r.is_floating_point())
    if order == 2:
        (d_in,) = torch.autograd.grad(loss, incid, create_graph=True)
        loss = (d_in * weights(d_in)).sum()
    leaves = _leaves(mat, it, incid, out, w)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [r.detach() for r in res], got


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", ["eval", "sample", "pdf"])
def test_grad_inputs_take_the_kernel_route(name, order, recorded,
                                           monkeypatch):
    """Inputs that need a gradient take the kernel route (launched once,
    with gradients off, through _Replay), and the gradients equal the
    plain route's (`assert_grads`)."""
    inputs = _grad_inputs(4)
    want_res, want = _grads(name, "plain", inputs, order)
    ran = _stub_card(monkeypatch, name)
    got_res, got = _grads(name, "routed", inputs, order)
    assert ran == [False] and _counters() == (1, 0)
    assert_same(got_res, want_res)
    assert_grads(got, want, order)
    assert any(a is not None and a.nan_to_num().abs().sum() > 0
               for a in got)


def test_no_grad_mode_launches_plainly(recorded, monkeypatch):
    """Under no_grad the launch is called directly: no _Replay, and the
    result carries no graph."""
    ran = _stub_card(monkeypatch, "eval")
    mat, it, incid, out, _u, w = _grad_inputs(5)
    with torch.no_grad():
        res = bxdf_ops.surface_eval(cfg_of(ARMS), mat, it, incid, out, w)
    assert ran == [False] and res.grad_fn is None
    assert _counters() == (1, 0)


# ------------------------------ on the card ------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cases():
    for arm, arm_id in zip(ARMS, ARM_IDS):
        for name in ("eval", "sample", "pdf"):
            modes = ["uni"] if name == "pdf" else list(MODES)
            for mode in modes:
                for two_sides in (False, True):
                    for textured in (False, True):
                        yield pytest.param(
                            arm, name, mode, two_sides, textured,
                            id=f"{arm_id}-{name}-{mode}"
                               f"-{'two' if two_sides else 'one'}"
                               f"-{'tex' if textured else 'kd'}")


@pytest.mark.cuda
@pytest.mark.parametrize("arm,name,mode,two_sides,textured", list(_cases()))
def test_kernel_equals_plain_on_card(arm, name, mode, two_sides, textured):
    dev = _card()
    seed = 100 + ARMS.index(arm)
    mat, it, incid, out, u = on_device(
        wavefront(seed, [arm], textured=textured), dev)
    cfg = cfg_of([arm], two_sides)
    w = torch.tensor([1.0, 1.33], device=dev)[int(arm[0] and seed % 2)]
    before = _build.launches["shade_kernels"]["surface_" + name]
    got = call(name, "routed", cfg, mat, it, incid, out, u, w, MODES[mode])
    assert _build.launches["shade_kernels"]["surface_" + name] == before + 1
    want = call(name, "plain", cfg, mat, it, incid, out, u, w, MODES[mode])
    assert_same(got, want)
    if name == "sample" and arm == (False, BRDFTag.SPECULAR):
        assert got[3].all()


@pytest.mark.cuda
@pytest.mark.parametrize("scene_arms", ["all", "brdf_only", "bsdf_only"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mixed_wavefront_on_card(scene_arms, mode, recorded):
    """Every covered arm in one wavefront with lanes of a kind the scene
    does not list (BRDFTag.MIXTURE rows); the scene lists all arms, only
    its BRDFs or only its BSDFs (the other lanes take the defaults)."""
    dev = _card()
    mat, it, incid, out, u = on_device(
        wavefront(7, ARMS, textured=True,
                  extra_kinds=(BRDFTag.MIXTURE,)), dev)
    listed = {"all": ARMS, "brdf_only": [a for a in ARMS if not a[0]],
              "bsdf_only": [a for a in ARMS if a[0]]}[scene_arms]
    cfg = cfg_of(listed, two_sides=True)
    # the world's ior as a device scalar, and as a Python number
    w = 1.0 if mode == "imp" else torch.tensor(1.0, device=dev)
    for name in ("eval", "sample", "pdf"):
        assert_same(
            call(name, "routed", cfg, mat, it, incid, out, u, w, MODES[mode]),
            call(name, "plain", cfg, mat, it, incid, out, u, w, MODES[mode]))
    assert _counters() == (3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", ["eval", "sample", "pdf"])
def test_grad_on_card_equals_plain(name, order, recorded):
    """On the card, inputs that need a gradient take the kernel (one
    launch): outputs bit for bit and gradients (`assert_grads`) equal
    the plain version's on the card."""
    dev = _card()
    inputs = [x.to(dev) if torch.is_tensor(x) else x
              for x in _grad_inputs(6)]
    for k in (0, 1):       # the dataclasses, field by field
        inputs[k] = dataclasses.replace(inputs[k], **{
            f.name: getattr(inputs[k], f.name).to(dev)
            for f in dataclasses.fields(inputs[k])
            if torch.is_tensor(getattr(inputs[k], f.name))})
    want_res, want = _grads(name, "plain", inputs, order)
    before = _build.launches["shade_kernels"]["surface_" + name]
    got_res, got = _grads(name, "routed", inputs, order)
    assert _build.launches["shade_kernels"]["surface_" + name] == before + 1
    assert _counters() == (1, 0)
    assert_same(got_res, want_res)
    assert_grads(got, want, order)


@pytest.mark.cuda
def test_unknown_tag_is_refused_on_card():
    """A scene listing a BRDF tag csrc/shade.cu does not know is refused
    at the launch, and nothing is launched."""
    dev = _card()
    mat, it, incid, out, u = on_device(wavefront(8, ARMS, n=256), dev)
    cfg = cfg_of(ARMS)
    cfg.brdf_types = cfg.brdf_types + (BRDFTag.MIXTURE,)
    before = dict(_build.launches["shade_kernels"])
    for name in ("eval", "sample", "pdf"):
        with pytest.raises(ValueError, match="does not know"):
            call(name, "routed", cfg, mat, it, incid, out, u, 1.0,
                 TRANSPORT_UNI)
    assert _build.launches["shade_kernels"] == before


def _small(cfg, w=32, mb=3):
    return dataclasses.replace(
        cfg, w=w, h=w, focal=cfg.focal * w / cfg.w, end_x=w, end_y=w,
        max_bounce=mb, anti_alias=False, stratified_sampling=False,
        use_rr=False)


MIXTURE_XML = """<?xml version='1.0' encoding='utf-8'?>
<scene version="1.1">
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <integer name="max_bounce" value="3"/>
    <integer name="num_shadow_ray" value="1"/>
    <boolean name="use_rr" value="false"/>
    <boolean name="anti_alias" value="false"/>
    <boolean name="stratified_sampling" value="false"/>
    <boolean name="use_mis" value="true"/>
    <transform name="toWorld">
      <lookat target="0, 0, 1" origin="0, 0, -4" up="0, 1, 0"/>
    </transform>
    <film type="film">
      <integer name="width" value="32"/>
      <integer name="height" value="32"/>
    </film>
  </sensor>
  <emitter type="point" id="point">
    <rgb name="emission" value="40.0, 40.0, 40.0"/>
    <rgb name="scaler" value="1.0"/>
    <point name="center" x="0" y="3" z="-2"/>
  </emitter>
  <brdf type="lambertian" id="a">
    <rgb name="k_d" value="0.8, 0.2, 0.6"/>
  </brdf>
  <brdf type="microfacet" id="c">
    <rgb name="k_d" value="0.9"/>
    <rgb name="k_s" value="1.0, 1.5, 0"/>
    <rgb name="roughness" value="0.35, 0.35, 0"/>
  </brdf>
  <bsdf type="det-refraction" id="glass">
    <rgb name="k_d" value="#FAFAFA"/>
    <medium type="transparent">
      <rgb name="u_a" value="0.0"/>
      <rgb name="u_s" value="0.0"/>
      <rgb name="par" value="0.0"/>
      <float name="ior" value="1.5"/>
    </medium>
  </bsdf>
  <brdf type="mixture" id="ball">
    <ref name="diffuse" id="a"/>
    <ref name="glossy" id="c"/>
    <ref name="transmit" id="glass"/>
    <float name="p_d" value="0.4"/>
    <float name="p_g" value="0.3"/>
    <float name="p_t" value="0.2"/>
  </brdf>
  <shape type="sphere">
    <point name="center" x="0" y="0" z="0.5"/>
    <float name="radius" value="1.2"/>
    <ref type="material" id="ball"/>
  </shape>
  <world name="w">
    <rgb name="skybox" value="0.0"/>
    <rgb name="ambient" value="0.0"/>
  </world>
</scene>
"""


def _render(kind, scene, cfg, passes=2):
    from adapt_tpu_torch.renderer import bdpt, pt, vpt
    cls = {"pt": pt.Renderer, "bdpt": bdpt.BDPT,
           "vpt": vpt.VolumeRenderer}[kind]
    r = cls(scene, cfg, seed=5)
    for _ in range(passes):
        r.render()
    return torch.from_numpy(np.ascontiguousarray(r.image()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,where,name", [
    ("pt", "cbox", "cbox.xml"), ("pt", "csphere", "balls-multi.xml"),
    ("pt", "mixture", None), ("bdpt", "cbox", "cbox.xml"),
    ("bdpt", "mixture", None), ("bdpt", "csphere", "balls-multi.xml"),
    ("vpt", "mixture", None),
    ("vpt", "vpt", "cbox.xml")])
def test_render_on_card_equals_plain(kind, where, name, tmp_path,
                                     monkeypatch, recorded):
    """A whole render through the kernels equals the render through the
    plain version, bit for bit, and every shading call took the kernel."""
    dev = _card()
    if name is None:
        (tmp_path / "scene.xml").write_text(MIXTURE_XML)
        d, name = str(tmp_path), "scene.xml"
    else:
        d = os.path.join(SCENE_DIR, where)
    scene, cfg, _ = load_scene(d, name, device=dev)
    cfg = _small(cfg)
    got = _render(kind, scene, cfg)
    k, eager = _counters()
    assert k > 0 and eager == 0
    monkeypatch.setattr(shade_kernels, "route", lambda *a, **kw: False)
    assert_same((got,), (_render(kind, scene, cfg),))
