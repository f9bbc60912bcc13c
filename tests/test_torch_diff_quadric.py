"""The port's edge-aware NEE terms on quadric occluders and against a
non-sphere lamp (tests/test_diff.py:TestEdgeAwareQuadricAndLight), on
the CPU in f64: central differences on the port, and the gradients
against the JAX package's.  The JAX package's value_and_grad of the
ellipsoid-lamp scene runs in a fresh interpreter, as tests/test_diff.py
runs it: XLA:CPU has crashed compiling it after other programs in the
same process."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_diff import (assert_matches_jax, edge_fd, jax_value_and_grad,
                         port_setup)
from _torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("name", ["edge_ellipsoid", "edge_cylinder"])
def test_quadric_grads_match_jax(name):
    dr, q0 = port_setup(name, "uniform", edge_aware=True)
    assert_matches_jax(dr.value_and_grad(q0),
                       jax_value_and_grad(name, "uniform", edge_aware=True))


def test_ellipsoid_light_grads_match_jax(tmp_path):
    out = tmp_path / "jax.npz"
    code = (
        "import json, sys, numpy as np\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "from _torch_diff import jax_value_and_grad\n"
        "val, g = jax_value_and_grad('edge_ellipsoid_light', 'uniform',"
        " edge_aware=True)\n"
        "flat = {f'{k}|{n}': v for k, grp in g.items()"
        " for n, v in grp.items()}\n"
        f"np.savez({str(out)!r}, __loss=np.float64(val), **flat)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    z = np.load(out)
    grads = {}
    for name in z.files:
        if name != "__loss":
            g, k = name.split("|")
            grads.setdefault(g, {})[k] = z[name]
    dr, q0 = port_setup("edge_ellipsoid_light", "uniform", edge_aware=True)
    assert_matches_jax(dr.value_and_grad(q0), (float(z["__loss"]), grads))


# (scene, key, flat index, rtol): the quadric occluder's m0 x entry (the
# world translation), and the sphere occluder under the ellipsoid lamp
# (sphere row 0: the lamp is a quadric)
EDGE = [("edge_ellipsoid", "qua_m0", 0, 0.3),
        ("edge_cylinder", "qua_m0", 0, 0.3),
        ("edge_ellipsoid_light", "sph_c", 0, 0.35)]


@pytest.mark.parametrize("name,key,idx,rtol", EDGE,
                         ids=[c[0] for c in EDGE])
def test_quadric_edge_term_matches_fd(name, key, idx, rtol):
    val, g_ad, g_fd = edge_fd(name, key, idx)
    assert np.isfinite(val)
    assert abs(g_fd) > 1e-3
    assert abs(g_ad - g_fd) <= rtol * abs(g_fd), (g_ad, g_fd)
