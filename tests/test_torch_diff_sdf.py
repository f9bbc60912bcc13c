"""The port's differentiable renderer through a standalone SDF object
(the implicit-function reattach of Tracer._hit_sdf_leaf) and over the
whole smoke scene glass_table, on the CPU in f64: central differences
on the port (tests/test_diff.py:TestSdfGrads), and the gradients against
the JAX package's (the contract of test_torch_diff.py)."""

import pytest

from _torch_diff import (assert_matches_jax, fd_check, jax_value_and_grad,
                         port_setup)


def test_torus_grads_match_jax():
    dr, q0 = port_setup("torus")
    assert_matches_jax(dr.value_and_grad(q0), jax_value_and_grad("torus"))


def test_glass_table_grads_match_jax():
    """The slice as a whole: glass_table (glass CSG goblet with quadric
    leaves, wine, a mirror ball, a sphere lamp and an ellipsoid lamp) at
    20x15, depth 8, balanced selection."""
    dr, q0 = port_setup("glass_table", "balanced")
    got = dr.value_and_grad(q0)
    assert_matches_jax(got, jax_value_and_grad("glass_table", "balanced"))
    assert float(got[1]["geom"]["qua_m0"].abs().max()) > 0


def test_sdf_params_exported():
    dr, _ = port_setup("torus")
    g = dr.params()["geom"]
    assert "sdfs0_m" in g and "sdfs0_m0" in g and "sdfs0_prm" in g


# the torus shows in few pixels of the 8x6 image, so seed 6 is a pixel set
# whose rays shade it; delta 1e-6, as a step of 1e-5 crosses a shadow edge
# (entries: prm = tube / ring radius, m0 z = the translation, m one
# rotation / scale entry of the local frame)
@pytest.mark.parametrize("key,idx", [("sdfs0_prm", 0), ("sdfs0_m0", 2),
                                     ("sdfs0_m", 4)])
def test_torus_fd(key, idx):
    dr, q0 = port_setup("torus")
    g_ad, _ = fd_check(dr, q0, "geom", key, idx, 1e-6, 3e-2)
    assert g_ad != 0
