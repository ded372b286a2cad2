"""The byte bounds against counts made by hand."""
from types import SimpleNamespace

import pytest
import torch

from port_bench import bounds


def scene(T=34, nodes=10, prims=20):
    return SimpleNamespace(
        tri_geo=torch.zeros(T, 12), tri_ng=torch.zeros(T, 3),
        tri_obj=torch.zeros(T, dtype=torch.int32),
        bvh_node_v4=torch.zeros(nodes, 4), bvh_prim_v4=torch.zeros(prims, 4))


def test_closest_hit_bytes():
    # 100 rays, 60 walking: 60 * 28 + 40 * 4 in; 34 rows of 64 B; 32 B out
    assert bounds.tri_closest_hit(scene(), 100, 60) \
        == 60 * 28 + 40 * 4 + 34 * 64 + 100 * 32


def test_any_hit_bytes():
    assert bounds.tri_any_hit(scene(), 100, 100) \
        == 100 * 28 + 34 * 48 + 100


def test_bvh_bytes():
    assert bounds.bvh_closest_hit(scene(), 10, 10) \
        == 280 + (10 + 20) * 16 + 160
    assert bounds.bvh_any_hit(scene(), 10, 0) == 40 + (10 + 20) * 16 + 10


def test_bound_ms():
    assert bounds.bound_ms(3.35e9) == pytest.approx(1.0)
