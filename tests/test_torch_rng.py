"""The port's counter RNG and vector algebra against the JAX package's.

The RNG must be bit-exact (position-seeded streams hash the f32 bits of
hit points; counter-mode streams must replay the same draws in both
packages); math3d is compared with allclose at 1e-12 in f64."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from actinon_tpu import math3d as jm3
from actinon_tpu import rng as jrng
from actinon_tpu_torch import math3d as tm3
from actinon_tpu_torch import rng as trng
from _torch_threads import one_torch_thread  # noqa: F401

N = 4096


def _u32(rng, n=N):
    return rng.integers(0, 2 ** 32, n, dtype=np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_fmix32_and_mix_bit_exact():
    rng = np.random.default_rng(0)
    h = _u32(rng)
    np.testing.assert_array_equal(
        trng._fmix32(_t(h)).numpy(),
        np.asarray(jrng._fmix32(jnp.asarray(h))).astype(np.int64))
    s, c = _u32(rng), _u32(rng)
    np.testing.assert_array_equal(
        trng.mix(_t(s), _t(c)).numpy(),
        np.asarray(jrng.mix(s, c)).astype(np.int64))


@pytest.mark.parametrize("dtype,tdtype", [(np.float32, torch.float32),
                                          (np.float64, torch.float64)])
def test_uniform_bit_exact(dtype, tdtype):
    rng = np.random.default_rng(1)
    s = _u32(rng)
    for counter in (0, 1, 7, 4 * 199 + 1, 2 ** 31 + 5):
        want = np.asarray(jrng.uniform(s, counter, dtype))
        got = trng.uniform(_t(s), counter, tdtype).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jrng.uniform_signed(s, counter, dtype))
        got = trng.uniform_signed(_t(s), counter, tdtype).numpy()
        np.testing.assert_array_equal(got, want)


def test_seed_from_v3_and_fold_bit_exact():
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.normal(0, 5, (N, 3)),
                          [[0.0, -0.0, 1e-30], [np.inf, -np.inf, 3e38]]])
    for salt in (1246, 3294479285, 3247146734):
        want = np.asarray(jrng.seed_from_v3(pos, salt)).astype(np.int64)
        got = trng.seed_from_v3(torch.as_tensor(pos), salt).numpy()
        np.testing.assert_array_equal(got, want)
    a, b = _u32(rng), _u32(rng)
    np.testing.assert_array_equal(
        trng.fold(_t(a), _t(b)).numpy(),
        np.asarray(jrng.fold(a, b)).astype(np.int64))


def test_counter_stream_with_negative_depth():
    """Counter-mode streams fold in the depth as uint32: depth <= 0 wraps
    the same way in both packages."""
    sid = np.arange(64, dtype=np.int32)
    depth = np.arange(-32, 32, dtype=np.int32)
    want = jrng.fold(jrng.mix(jnp.asarray(sid).astype(jnp.uint32),
                              2654435769),
                     jnp.asarray(depth).astype(jnp.uint32))
    got = trng.fold(trng.mix(torch.as_tensor(sid, dtype=torch.int64),
                             2654435769),
                    torch.as_tensor(depth, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_to_uint32_round_trip():
    h = _u32(np.random.default_rng(3))
    u = trng.to_uint32(_t(h))
    assert u.dtype == torch.uint32
    np.testing.assert_array_equal(u.view(torch.int32).numpy().view(
        np.uint32), h)
    np.testing.assert_array_equal(trng.as_u32(u).numpy(), h.astype(np.int64))


def test_host_lcg_matches():
    a, b = jrng.HostLcg(12345), trng.HostLcg(12345)
    for _ in range(100):
        assert a.rnd1() == b.rnd1()
        assert a.rnd0() == b.rnd0()
    np.testing.assert_array_equal(a.sphere_belt(0.3), b.sphere_belt(0.3))
    assert a.state == b.state


def _vecs(seed, shape=(64, 3)):
    return np.random.default_rng(seed).normal(0, 2, shape)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["dot", "cross", "diff_sqr", "von",
                                  "reflect", "orthogonal_projection"])
def test_math3d_binary(name):
    a, b = _vecs(4), _vecs(5)
    b[:4] = b[:4] / np.linalg.norm(b[:4], axis=-1, keepdims=True)
    _close(getattr(tm3, name)(torch.as_tensor(a), torch.as_tensor(b)),
           getattr(jm3, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["sqr", "normalize", "con", "con_z",
                                  "con_y"])
def test_math3d_unary(name):
    v = _vecs(6)
    v[0] = 0.0
    v[1] = v[1] / np.linalg.norm(v[1])
    v[2] = (1.0, 1.0, 3.0)          # a tie in the canonic vector
    _close(getattr(tm3, name)(torch.as_tensor(v)),
           getattr(jm3, name)(jnp.asarray(v)))


def test_math3d_matrices_and_rotations():
    m, v = _vecs(7, (16, 3, 3)), _vecs(8, (16, 3))
    tm, tv = torch.as_tensor(m), torch.as_tensor(v)
    _close(tm3.mlv(tm, tv), jm3.mlv(m, v))
    _close(tm3.tmlv(tm, tv), jm3.tmlv(m, v))
    _close(tm3.mlm(tm, tm.flip(0)), jm3.mlm(m, m[::-1]))
    _close(tm3.transposed(tm), jm3.transposed(m))
    ang = np.linspace(-3.0, 3.0, 7)
    for name in ("rot_x", "rot_y", "rot_z"):
        _close(getattr(tm3, name)(torch.as_tensor(ang)),
               getattr(jm3, name)(jnp.asarray(ang)))
    _close(tm3.ray_pos(tv, tv, torch.as_tensor(ang[:1].repeat(16))),
           jm3.ray_pos(v, v, ang[:1].repeat(16)))


def test_math3d_sampling():
    rng = np.random.default_rng(9)
    u1, u2 = rng.uniform(size=(2, 256))
    h = rng.uniform(0, 2, 256)
    for name in ("sphere_cap_sample", "sphere_belt_sample"):
        _close(getattr(tm3, name)(torch.as_tensor(u1), torch.as_tensor(u2),
                                  torch.as_tensor(h)),
               getattr(jm3, name)(u1, u2, h))
    c = rng.uniform(-0.5, 2.0, (32, 3))
    _close(tm3.saturate_color(torch.as_tensor(c), 0.8),
           jm3.saturate_color(c, 0.8))
