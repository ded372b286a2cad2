"""The unified surface dispatch in one CUDA kernel a call.

`surface_eval`, `surface_sample` and `surface_pdf` here launch
csrc/shade.cu's `shade_eval_kernel`, `shade_sample_kernel` and
`shade_pdf_kernel` (built by ops/_build.py): a thread shades one lane,
switching on the lane's material kind, where ops/bxdf_ops.py's plain
version (`surface_*_plain`) runs every arm of the scene over every lane
and merges them with selects. The kernels give the plain version's bits.
They replace no Pallas kernel: the JAX package leaves its BxDF arms to
XLA. BxDF-mixture lanes are overlaid by bxdf_ops.py, as on the plain
route.

bxdf_ops.py's `surface_*` ask `route` first: the kernels take every call
whose tensors lie on a CUDA device; a call on CPU tensors takes the plain
version. Where an input needs a gradient while gradients are enabled
(differentiable rendering), the kernel still gives the forward, and the
backward is the plain version's (`_Replay`): it recomputes the plain
result from the saved inputs and returns its vector-Jacobian product. A
scene that lists a tag csrc/shade.cu does not know is refused at the
launch (ValueError), not shaded. The counters `shade.kernel` and
`shade.eager` say how often each route was taken; ops/_build.py launches
the kernels and counts them.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import obs
from ..constants import TRANSPORT_UNI
from . import _build

def _inputs(mat, it, dirs, world_ior):
    ts = [mat.kind, mat.is_bsdf, mat.kd, mat.ks, mat.kg, mat.mean, mat.ior,
          it.n_s, it.n_g, *dirs]
    if it.tex is not None:
        ts.append(it.tex)
    if torch.is_tensor(world_ior):
        ts.append(world_ior)
    return ts


def _on_card(ts):
    return all(t.is_cuda for t in ts)


def route(mat, it, dirs, world_ior) -> bool:
    """True where the call takes the kernel (its tensors lie on a CUDA
    device); counts the route taken. dirs: the call's direction tensors
    (and uniforms)."""
    if _on_card(_inputs(mat, it, dirs, world_ior)):
        obs.count("shade.kernel")
        return True
    obs.count("shade.eager")
    return False


_P = ctypes.c_void_p


class _ShadeIn(ctypes.Structure):
    """csrc/shade.cu `ShadeIn`, field for field."""
    _fields_ = [("kind", _P), ("is_bsdf", _P), ("kd", _P), ("ks", _P),
                ("kg", _P), ("mean", _P), ("ior", _P), ("n_s", _P),
                ("n_g", _P), ("tex", _P), ("incid", _P), ("dir", _P),
                ("u", _P), ("u_stride", ctypes.c_longlong), ("wior", _P),
                ("wior_val", ctypes.c_float),
                ("brdf_mask", ctypes.c_uint), ("bsdf_mask", ctypes.c_uint),
                ("two_sides", ctypes.c_int), ("mode", ctypes.c_int),
                ("n", ctypes.c_int)]


def _refused(wrapper, err, args):
    """The ValueError of csrc/shade.cu's UNKNOWN_TAG (-1: nothing
    launched); None for any other status."""
    if err == -1:
        cfg = args[0].cfg
        return ValueError(f"{wrapper}: the scene lists a material tag "
                          f"csrc/shade.cu does not know (BRDFs "
                          f"{tuple(cfg.brdf_types)}, BSDFs "
                          f"{tuple(cfg.bsdf_types)})")
    return None


_IN = ctypes.POINTER(_ShadeIn)
_LIB = _build.Library(__name__, "shade", {
    "surface_eval": ("shade_eval", "shade_eval_kernel", [_IN, _P, _P]),
    "surface_sample": ("shade_sample", "shade_sample_kernel",
                       [_IN, _P, _P, _P, _P, _P]),
    "surface_pdf": ("shade_pdf", "shade_pdf_kernel", [_IN, _P, _P])},
    refused=_refused)
# each wrapper's kernel, by the name the profiler gives it
kernel_names = _LIB.kernel_names


def _rows(t, n, width, name, dtype=torch.float32):
    """t as contiguous (n,) or (n, width) rows of dtype, or raise."""
    shape = (n,) if width is None else (n, width)
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dtype} of shape {shape}, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    return t.contiguous()


def _operands(cfg, mat, it, incid, d, u, world_ior, mode):
    """The call's ShadeIn (holding cfg, which a refusal names), and the
    tensors it points into (kept alive until the launch is queued)."""
    n = incid.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} lanes do not fit in a 32-bit int")
    keep = [_rows(mat.kind, n, None, "mat.kind", torch.int32),
            _rows(mat.is_bsdf, n, None, "mat.is_bsdf", torch.bool)]
    keep += [_rows(t, n, 3, f"mat.{k}") for k, t in
             (("kd", mat.kd), ("ks", mat.ks), ("kg", mat.kg),
              ("mean", mat.mean))]
    keep += [_rows(mat.ior, n, None, "mat.ior"),
             _rows(it.n_s, n, 3, "it.n_s"), _rows(it.n_g, n, 3, "it.n_g")]
    tex = None if it.tex is None else _rows(it.tex, n, 3, "it.tex")
    incid = _rows(incid, n, 3, "incid")
    d = None if d is None else _rows(d, n, 3, "direction")
    if u is not None:
        if u.dtype != torch.float32 or tuple(u.shape) != (n, 6):
            raise ValueError(f"u: want float32 of shape ({n}, 6), got "
                             f"{u.dtype} of shape {tuple(u.shape)}")
        if u.stride(1) != 1:
            u = u.contiguous()
    wior, val = None, 0.0
    if torch.is_tensor(world_ior):   # a device scalar: read by the kernel
        if world_ior.dtype != torch.float32 or world_ior.numel() != 1:
            raise ValueError(f"world_ior: want one float32 value, got "
                             f"{world_ior.dtype} of shape "
                             f"{tuple(world_ior.shape)}")
        wior = world_ior.reshape(1)
    else:
        val = float(world_ior)
    keep += [tex, incid, d, u, wior]
    ptr = lambda t: None if t is None else t.data_ptr()
    args = _ShadeIn(
        *(t.data_ptr() for t in keep[:9]), ptr(tex), incid.data_ptr(),
        ptr(d), ptr(u), 0 if u is None else u.stride(0), ptr(wior), val,
        sum(1 << t for t in cfg.brdf_types),
        sum(1 << (t + 1) for t in cfg.bsdf_types), int(cfg.brdf_two_sides),
        int(mode), n)
    args.cfg = cfg
    return args, keep


def _eval(cfg, mat, it, incid, out, world_ior, mode):
    n = incid.shape[0]
    res = torch.empty((n, 3), dtype=torch.float32, device=incid.device)
    if n:
        args, _keep = _operands(cfg, mat, it, incid, out, None, world_ior,
                                mode)
        _LIB.launch("surface_eval", incid.device, n, args, res.data_ptr())
    return (res,)


def _sample(cfg, mat, it, incid, u, world_ior, mode):
    n = incid.shape[0]
    dev = incid.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    spec = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty(n, dtype=torch.float32, device=dev)
    is_specular = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        args, _keep = _operands(cfg, mat, it, incid, None, u, world_ior, mode)
        _LIB.launch("surface_sample", dev, n, args, out.data_ptr(),
                    spec.data_ptr(), pdf.data_ptr(), is_specular.data_ptr())
    return out, spec, pdf, is_specular


def _pdf(cfg, mat, it, outdir, incid, world_ior, mode):
    n = incid.shape[0]
    pdf = torch.empty(n, dtype=torch.float32, device=incid.device)
    if n:
        args, _keep = _operands(cfg, mat, it, incid, outdir, None, world_ior,
                                mode)
        _LIB.launch("surface_pdf", incid.device, n, args, pdf.data_ptr())
    return (pdf,)


# the launch of each call by name; all take (cfg, mat, it, a, b, world_ior,
# mode), a and b the call's two direction (or uniform) tensors
_LAUNCH = {"eval": _eval, "sample": _sample, "pdf": _pdf}


def _plain(name, cfg, mat, it, a, b, world_ior, mode):
    """bxdf_ops's plain base result of the call (no mixture overlay), as a
    tuple."""
    from . import bxdf_ops
    if name == "eval":
        return (bxdf_ops.surface_eval_plain(cfg, mat, it, a, b, world_ior,
                                            mode),)
    if name == "sample":
        return bxdf_ops.surface_sample_plain(cfg, mat, it, a, b, world_ior,
                                             mode)
    return (bxdf_ops.surface_pdf_plain(cfg, mat, it, a, b, world_ior),)


class _Replay(torch.autograd.Function):
    """The kernel's forward with the plain version's backward.
    forward(launch, replay, *ts): launch() gives the outputs; ts are the
    inputs that need a gradient. backward recomputes replay(ts), the plain
    version on them, under autograd and returns its vector-Jacobian
    product (a graph of it too, where the backward itself is
    differentiated)."""

    @staticmethod
    def forward(ctx, launch, replay, *ts):
        ctx.replay = replay
        ctx.save_for_backward(*ts)
        outs = launch()
        ctx.mark_non_differentiable(
            *(o for o in outs if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        create = torch.is_grad_enabled()
        ts = ctx.saved_tensors
        if not create:
            ts = [t.detach().requires_grad_() for t in ts]
        with torch.enable_grad():
            outs = ctx.replay(ts)
        pairs = [(o, g) for o, g in zip(outs, grads, strict=True)
                 if o.requires_grad and g is not None]
        if not pairs:
            return (None, None, *(None for _ in ts))
        got = torch.autograd.grad(
            [o for o, _ in pairs], ts, [g for _, g in pairs],
            allow_unused=True, create_graph=create)
        return (None, None, *got)


def _needing_grad(mat, it, a, b, world_ior):
    """(slot, tensor) of each input that needs a gradient; a slot is
    ("mat" | "it", field) or ("arg", 0 | 1 | 2), 2 being world_ior."""
    slots = [(("mat", f.name), getattr(mat, f.name))
             for f in dataclasses.fields(mat)]
    slots += [(("it", f.name), getattr(it, f.name))
              for f in dataclasses.fields(it)]
    slots += [(("arg", k), t) for k, t in enumerate((a, b, world_ior))]
    return [(slot, t) for slot, t in slots
            if torch.is_tensor(t) and t.requires_grad]


def _shade(name, cfg, mat, it, a, b, world_ior, mode):
    """The kernel's outputs of the call by name. Where an input needs a
    gradient while gradients are enabled, through _Replay, so that the
    gradient is the plain version's."""
    launch = _LAUNCH[name]
    held = _needing_grad(mat, it, a, b, world_ior) \
        if torch.is_grad_enabled() else []
    if not held:
        return launch(cfg, mat, it, a, b, world_ior, mode)
    slots = [slot for slot, _ in held]

    def replay(ts):
        parts = {"mat": {}, "it": {}, "arg": {}}
        for (where, key), t in zip(slots, ts, strict=True):
            parts[where][key] = t
        args = [parts["arg"].get(k, v)
                for k, v in enumerate((a, b, world_ior))]
        return _plain(name, cfg, dataclasses.replace(mat, **parts["mat"]),
                      dataclasses.replace(it, **parts["it"]), *args, mode)
    return _Replay.apply(
        lambda: launch(cfg, mat, it, a, b, world_ior, mode), replay,
        *(t for _, t in held))


def surface_eval(cfg, mat, it, incid, out, world_ior, mode=TRANSPORT_UNI):
    """bxdf_ops.surface_eval_plain's base result (no mixture overlay) in
    one shade_eval_kernel."""
    return _shade("eval", cfg, mat, it, incid, out, world_ior, mode)[0]


def surface_sample(cfg, mat, it, incid, u, world_ior, mode=TRANSPORT_UNI):
    """bxdf_ops.surface_sample_plain's base result in one
    shade_sample_kernel; u: (N, 6) uniforms, any row stride."""
    return tuple(_shade("sample", cfg, mat, it, incid, u, world_ior, mode))


def surface_pdf(cfg, mat, it, outdir, incid, world_ior):
    """bxdf_ops.surface_pdf_plain's base result in one shade_pdf_kernel."""
    return _shade("pdf", cfg, mat, it, outdir, incid, world_ior,
                  TRANSPORT_UNI)[0]
