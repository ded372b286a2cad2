"""The port's sorted film splat (ops/splat.py, kernel B4) against the JAX
package's tile kernel and a float64 scatter.

The plain version adds each pixel's updates in stream order; the JAX tile
kernel reduces them in chunk-tree order, so the two agree up to f32
reassociation: rtol 1e-5, atol 1e-5 (the film values are O(1) and a pixel
takes up to a few dozen adds). Against the float64 scatter the same bound
holds. The JAX kernel runs as tests/test_splat_pallas.py runs it, in
interpret mode (set by a fixture; nothing in adapt_tpu/ changes). The
kernel-vs-plain test needs the card and skips without one.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.ops import splat_pallas
from adapt_tpu_torch.ops import _build, splat

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = splat_pallas._INTERPRET
    splat_pallas._INTERPRET = True
    yield
    splat_pallas._INTERPRET = old


def _stream(P, M, seed, drop_frac=0.1, hi=None):
    """A pixel-sorted stream with a `drop` (= P) tail, as BDPT makes it."""
    g = np.random.default_rng(seed)
    idx = g.integers(0, P if hi is None else hi, M)
    idx = np.where(g.uniform(size=M) < drop_frac, P, idx)
    idx = np.sort(idx).astype(np.int32)
    rgb = g.uniform(size=(M, 3)).astype(np.float32)
    film = g.uniform(size=(P, 3)).astype(np.float32)
    return film, idx, rgb


def _scatter64(film, idx, rgb):
    out = film.astype(np.float64)
    ok = (idx >= 0) & (idx < film.shape[0])
    np.add.at(out, idx[ok], rgb[ok].astype(np.float64))
    return out


def _plain(film, idx, rgb):
    return splat.splat_sorted_accumulate(
        torch.from_numpy(film), torch.from_numpy(idx),
        torch.from_numpy(rgb)).numpy()


def _jax(film, idx, rgb):
    return np.asarray(splat_pallas.splat_sorted_accumulate(
        jnp.asarray(film), jnp.asarray(idx), *(jnp.asarray(rgb[:, c])
                                               for c in range(3))))


@pytest.mark.parametrize("P,M", [(4096, 30000), (2048, 500)])
def test_plain_matches_jax_kernel_and_scatter(P, M):
    film, idx, rgb = _stream(P, M, seed=P + M)
    got = _plain(film, idx, rgb)
    np.testing.assert_allclose(got, _jax(film, idx, rgb), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _scatter64(film, idx, rgb), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["indivisible", "empty", "skewed",
                                  "all_dropped"])
def test_tpu_fallback_cases(case):
    """The cases where the TPU kernel falls back to its scatter: a film not
    a multiple of its 1024-pixel tile, an empty stream, and one tile
    holding more than MAX_WIN updates; and a stream that is all `drop`.
    The port has no fallback: one path serves them all."""
    if case == "indivisible":
        film, idx, rgb = _stream(777, 1024, seed=4, drop_frac=0.0)
    elif case == "empty":
        film, idx, rgb = _stream(2048, 0, seed=5)
    elif case == "skewed":
        P = 2 * splat_pallas.SUPER_PX
        film, idx, rgb = _stream(P, splat_pallas.MAX_WIN + 512, seed=3,
                                 drop_frac=0.0, hi=splat_pallas.SUPER_PX)
        assert (idx < splat_pallas.SUPER_PX).sum() > splat_pallas.MAX_WIN
    else:
        film, _, rgb = _stream(1024, 640, seed=2)
        idx = np.full(640, 1024, np.int32)
    got = _plain(film, idx, rgb)
    np.testing.assert_allclose(got, _scatter64(film, idx, rgb), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _jax(film, idx, rgb), rtol=RTOL,
                               atol=ATOL)
    if case in ("empty", "all_dropped"):
        np.testing.assert_array_equal(got, film)


def _window_stream(case):
    """Streams the CUDA kernel's block windows must get right (a block owns
    256 consecutive pixels and scans its window 256 entries a step):
    segments longer than a step, so a step ends inside a segment; one
    pixel holding every update; negative ids next to `drop` ids with few
    kept between them; a film whose last block holds one pixel."""
    g = np.random.default_rng(len(case))
    if case == "long_segments":
        P = 1024
        idx = np.repeat(np.arange(0, P, 97), 301)            # 301 a pixel
    elif case == "one_pixel":
        P = 600
        idx = np.full(1500, 300)
    elif case == "negative_and_drop":
        P = 512
        idx = np.concatenate([np.full(700, -1), np.full(300, -7),
                              g.integers(255, 258, 5), np.full(900, P)])
    else:                                                  # "ragged_tile"
        P = 257
        idx = g.integers(0, P, 4000)
        idx[:300] = P - 1
    idx = np.sort(idx).astype(np.int32)
    rgb = g.uniform(size=(idx.shape[0], 3)).astype(np.float32)
    film = g.uniform(size=(P, 3)).astype(np.float32)
    return film, idx, rgb


WINDOW_CASES = ["long_segments", "one_pixel", "negative_and_drop",
                "ragged_tile"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_block_window_streams(case):
    film, idx, rgb = _window_stream(case)
    got = _plain(film, idx, rgb)
    np.testing.assert_allclose(got, _scatter64(film, idx, rgb), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _jax(film, idx, rgb), rtol=RTOL,
                               atol=ATOL)
    kept = (idx >= 0) & (idx < film.shape[0])
    assert (got != film).any(axis=1).sum() == len(np.unique(idx[kept]))


def test_plain_adds_in_stream_order():
    """Each pixel's sum is its updates added one by one in stream order,
    then the film: the CUDA kernel's order, so the two are bit-equal.
    Negative ids and ids >= P are ignored."""
    film, idx, rgb = _stream(300, 5000, seed=8, drop_frac=0.05)
    idx[:40] = -1
    idx = np.sort(idx).astype(np.int32)
    got = _plain(film, idx, rgb)
    acc = np.zeros_like(film)
    for j, p in enumerate(idx):
        if 0 <= p < film.shape[0]:
            acc[p] = (acc[p] + rgb[j]).astype(np.float32)
    np.testing.assert_array_equal(got, film + acc)


def test_wrapper_checks_and_cpu_path():
    film, idx, rgb = (torch.from_numpy(x) for x in _stream(64, 100, seed=1))
    _build.reset_launches()
    splat.splat_sorted_accumulate(film, idx, rgb)
    assert _build.launches["splat"] == {"splat_sorted_accumulate": 0}
    with pytest.raises(ValueError, match="idx"):
        splat.splat_sorted_accumulate(film, idx.long(), rgb)
    with pytest.raises(ValueError, match="rgb"):
        splat.splat_sorted_accumulate(film, idx, rgb[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        splat.splat_sorted_accumulate(film, idx, rgb.T.contiguous().T)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        splat.splat_sorted_accumulate(
            meta, torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros((2, 3), device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    P = 1 << 16
    streams = [_stream(P, 6 * P, seed=11),
               _stream(P, 70000, seed=12, drop_frac=0.0, hi=1024),
               _stream(777, 1024, seed=13), _stream(P, 0, seed=14),
               *(_window_stream(case) for case in WINDOW_CASES)]
    before = _build.launches["splat"]["splat_sorted_accumulate"]
    for film, idx, rgb in streams:
        args = [torch.from_numpy(x).cuda() for x in (film, idx, rgb)]
        got = splat.splat_sorted_accumulate(*args)
        want = splat.splat_sorted_accumulate_plain(*args)
        torch.cuda.synchronize()
        # the same adds in the same order: bit-equal
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert _build.launches["splat"]["splat_sorted_accumulate"] \
        == before + len(streams)
