"""The port's threefry2x32 stream is bit-equal to jax.random's.

Covers PRNGKey, split, fold_in, uniform and the per-lane draw of
renderer/compact.py `lane_uniform`, across seeds, shapes and widths D.
On a CUDA device the two draws are hand-written kernels (csrc/rng.cu):
the cases marked `cuda` hold them bit for bit to the int64 twin (the CPU
path) and to jax.random, and skip without a card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adapt_tpu.renderer.compact import lane_uniform as jax_lane_uniform
from adapt_tpu_torch import obs, rng
from adapt_tpu_torch.ops import _build
from adapt_tpu_torch.convert import key_from_numpy, key_to_numpy

SEEDS = (0, 1, 42, 7919, 2 ** 31 - 1, -5)


def _words(jkey):
    return key_from_numpy(np.asarray(jax.random.key_data(jkey)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed)
    assert _words(jk) == tk
    for num in (2, 3, 5):
        assert [_words(k) for k in jax.random.split(jk, num)] \
            == rng.split(tk, num)
    for data in (0, 1, 7, 7919, 2 ** 31 - 1, 262143):
        assert _words(jax.random.fold_in(jk, data)) == rng.fold_in(tk, data)
    # chained, as the renderers use them
    a, b = jax.random.split(jax.random.fold_in(jk, 3))
    ta, tb = rng.split(rng.fold_in(tk, 3))
    assert (_words(a), _words(b)) == (ta, tb)
    np.testing.assert_array_equal(key_to_numpy(tk),
                                  np.asarray(jax.random.key_data(jk)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (13, 2), (4, 5, 3), (1031,)])
def test_uniform(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = rng.uniform(_words(jk), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", [1, 7, 11])
@pytest.mark.parametrize("seed", [0, 42, 12345])
def test_lane_uniform(seed, D):
    it_key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    # original lane ids need not be in order (compaction permutes them)
    pos = np.random.default_rng(seed).permutation(97).astype(np.int32)
    want = np.asarray(jax_lane_uniform(it_key, jnp.asarray(pos), D))
    got = rng.lane_uniform(_words(it_key), torch.from_numpy(pos), D)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_draws_launch_no_kernel():
    _build.reset_launches()
    rng.uniform(rng.PRNGKey(3), (5, 2))
    rng.lane_uniform(rng.PRNGKey(4), torch.arange(9, dtype=torch.int32), 3)
    assert _build.launches["rng"] == {"lane_uniform": 0, "uniform": 0}
    assert obs.export()["counters"]["launches"]["rng"] \
        == _build.launches["rng"]


@pytest.mark.parametrize("pos, D, what", [
    (torch.zeros(4, dtype=torch.float32), 3, "int32 or int64"),
    (torch.zeros((2, 2), dtype=torch.int32), 3, "1-D"),
    (torch.zeros(8, dtype=torch.int64)[::2], 3, "contiguous"),
    (torch.zeros(4, dtype=torch.int32), 0, "at least 1")])
def test_kernel_wrapper_checks(pos, D, what):
    """The CUDA wrapper refuses what its kernel does not take, before any
    launch (so the checks run on the CPU too)."""
    with pytest.raises(ValueError, match=what):
        rng._lane_uniform_cuda(rng.PRNGKey(1), pos, D)


# keys of both kinds: from a seed, and with the top bit of each word set
CARD_KEYS = ((0, 42), (0x9E3779B9, 0xF0000001))
CARD_LANES = (0, 1, 1000, 262144)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("D", [1, 7, 11, 15])
def test_lane_uniform_kernel_on_card(D, dtype):
    dev = _card()
    g = np.random.default_rng(D)
    for key in CARD_KEYS:
        for n in CARD_LANES:
            # original lane ids near 2^31 - 1, in no order
            pos = (2 ** 31 - 1 - g.permutation(n)).astype(np.int32)
            if dtype == torch.int64:   # and the low 32 bits of larger ids
                pos = pos.astype(np.int64) + (g.integers(0, 4, n) << 32)
            before = _build.launches["rng"]["lane_uniform"]
            got = rng.lane_uniform(key, torch.from_numpy(pos).to(dev), D)
            torch.cuda.synchronize()
            assert _build.launches["rng"]["lane_uniform"] == before + (n > 0)
            assert got.dtype == torch.float32 and got.shape == (n, D)
            want = rng.lane_uniform(key, torch.from_numpy(pos), D)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
            if n <= 1000:
                jk = jnp.asarray(key_to_numpy(key))
                jpos = jnp.asarray(pos.astype(np.uint32).view(np.int32))
                np.testing.assert_array_equal(
                    got.cpu().numpy(),
                    np.asarray(jax_lane_uniform(jk, jpos, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(262144,), (262144, 2), (262144, 6),
                                   (1031, 5)])
def test_uniform_kernel_on_card(shape):
    dev = _card()
    for key in CARD_KEYS:
        before = _build.launches["rng"]["uniform"]
        got = rng.uniform(key, shape, device=dev)
        torch.cuda.synchronize()
        assert _build.launches["rng"]["uniform"] == before + 1
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      rng.uniform(key, shape).numpy())
        np.testing.assert_array_equal(
            got.cpu().numpy(), np.asarray(jax.random.uniform(
                jnp.asarray(key_to_numpy(key)), shape)))
