"""The port's edge-aware NEE terms (Integrator._nee_edge_terms) on the
CPU in f64: tests/test_diff.py's sphere, half-space and CSG occluders.
The shading rays start below the occluder, so the image depends on the
occluder only through its moving shadow edge: interior-only gradients
miss it, and the edge-aware ones must match central differences.  Each
scene's gradients also equal the JAX package's (the contract of
test_torch_diff.py)."""

import numpy as np
import pytest

from _torch_diff import (assert_matches_jax, edge_fd, jax_value_and_grad,
                         port_setup)

SCENES = ["edge_sphere", "edge_plane", "edge_csg"]


@pytest.mark.parametrize("name", SCENES)
def test_edge_grads_match_jax(name):
    dr, q0 = port_setup(name, "uniform", edge_aware=True)
    assert_matches_jax(dr.value_and_grad(q0),
                       jax_value_and_grad(name, "uniform", edge_aware=True))


# (scene, key, flat index, rtol): the sphere occluder's centre x (row 1,
# the lamp is row 0), the occluding half-space's offset (plane row 1), and
# the x of the CSG lens's leaf B, whose surface the shadow rays graze
EDGE = [("edge_sphere", "sph_c", 3, 0.25), ("edge_plane", "pla_k", 1, 0.3),
        ("edge_csg", "c0_l1_c", 0, 0.3)]


@pytest.mark.parametrize("name,key,idx,rtol", EDGE,
                         ids=[c[0] for c in EDGE])
def test_edge_term_matches_fd(name, key, idx, rtol):
    val, g_ad, g_fd = edge_fd(name, key, idx)
    assert np.isfinite(val)
    assert abs(g_fd) > 1e-3
    assert abs(g_ad - g_fd) <= rtol * abs(g_fd), (g_ad, g_fd)


def test_interior_only_gradient_is_wrong():
    """Without the edge term the occluder's gradient misses the shadow
    edge's derivative."""
    _, g_ad, g_fd = edge_fd("edge_sphere", "sph_c", 3, edge_aware=False)
    assert abs(g_ad - g_fd) > 0.5 * abs(g_fd), (g_ad, g_fd)
