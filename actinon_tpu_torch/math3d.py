"""Batched 3-vector / 3x3-matrix algebra over torch tensors.

Counterpart of the reference's inline vector layer (reference
src/vectors.h:53-332) and of the JAX package's `math3d.py`.  All
functions operate on tensors whose last axis is the vector axis (shape
``[..., 3]``) or the matrix axes (``[..., 3, 3]``, row convention:
``mlv(M, v) == M @ v``), broadcast over any leading batch shape, in the
dtype of their inputs.
"""

from __future__ import annotations

import math

import torch


def dot(a, b):
    """Inner product along the last axis (v3d_s_mlv, reference
    src/vectors.h:135)."""
    return torch.sum(a * b, dim=-1)


def sqr(a):
    """Squared length (v3d_s_sqr, reference src/vectors.h:116)."""
    return torch.sum(a * a, dim=-1)


def cross(a, b):
    """Cross product (v3d_s_mlx, reference src/vectors.h:124)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def diff_sqr(a, b):
    return sqr(a - b)


def of_length(v, a):
    """Set |v| to abs(a); zero vector maps to zero; vectors already unit
    length (within 1e-8 of squared norm) pass through unchanged — exact
    semantics of v3d_s_of_length (reference src/vectors.h:148-154)."""
    r2 = sqr(v)
    f = torch.where(r2 > 0, a / torch.sqrt(torch.where(r2 > 0, r2, 1.0)),
                    0.0)
    keep = torch.abs(r2 - 1.0) < 1e-8
    return torch.where(keep[..., None], v, v * f[..., None])


def normalize(v):
    return of_length(v, 1.0)


def von(o, v):
    """Orthonormal component of v w.r.t. direction o
    (v3d_s_von, reference src/vectors.h:157-162)."""
    o_n = normalize(o)
    v = v - o_n * dot(o_n, v)[..., None]
    return normalize(v)


def con(o):
    """Canonic orthonormal vector to o (v3d_s_con, reference
    src/vectors.h:165-175): start from the indicator of the minimal
    squared component (ties produce multiple ones, as in the reference),
    then orthonormalize against o."""
    xx, yy, zz = o[..., 0] ** 2, o[..., 1] ** 2, o[..., 2] ** 2
    ex = ((xx <= yy) & (xx <= zz)).to(o.dtype)
    ey = ((yy <= xx) & (yy <= zz)).to(o.dtype)
    ez = ((zz <= xx) & (zz <= yy)).to(o.dtype)
    v = torch.stack([ex, ey, ez], dim=-1)
    return von(o, v)


def reflect(d, n):
    """Reflection of direction d on surface with normal n, renormalized
    (v3d_s_reflection, reference src/vectors.h:238-241)."""
    return normalize(d - n * (2.0 * dot(d, n))[..., None])


def orthogonal_projection(o, nor):
    """o projected onto the plane with normal nor
    (reference src/vectors.h:223-232)."""
    return o - nor * dot(o, nor)[..., None]


# --------------------------------------------------------------------------
# 3x3 matrices, row convention ([..., 3, 3])


def mlv(m, v):
    """m @ v (m3d_s_mlv, reference src/vectors.h:256-265)."""
    return torch.einsum("...ij,...j->...i", m, v)


def tmlv(m, v):
    """transposed(m) @ v (m3d_s_tmlv, reference src/vectors.h:268-276)."""
    return torch.einsum("...ji,...j->...i", m, v)


def mlm(a, b):
    """Composition matching m3d_s_mlm (reference src/vectors.h:278-281):
    each row i of the result is a @ (row i of b).  Note this equals
    ``b @ a.T`` in standard notation; the reference uses it with rotation
    arguments where rows are the frame axes."""
    return torch.einsum("...ij,...kj->...ki", a, b)


def transposed(m):
    return torch.swapaxes(m, -1, -2)


def _rot(a, rows):
    a = torch.as_tensor(a)
    sa, ca = torch.sin(a), torch.cos(a)
    z, o = torch.zeros_like(sa), torch.ones_like(sa)
    env = dict(sa=sa, ca=ca, z=z, o=o, nsa=-sa)
    return torch.stack([torch.stack([env[k] for k in r], dim=-1)
                        for r in rows], dim=-2)


def rot_x(a):
    """Rotation around x, angle in radians (reference
    src/vectors.h:289-293)."""
    return _rot(a, (("o", "z", "z"), ("z", "ca", "nsa"), ("z", "sa", "ca")))


def rot_y(a):
    return _rot(a, (("ca", "z", "sa"), ("z", "o", "z"), ("nsa", "z", "ca")))


def rot_z(a):
    return _rot(a, (("ca", "nsa", "z"), ("sa", "ca", "z"), ("z", "z", "o")))


def con_z(v):
    """Orthonormal frame with z-row parallel to v (m3d_s_con_z, reference
    src/vectors.h:315-322)."""
    mz = normalize(v)
    mx = con(v)
    my = cross(mz, mx)
    return torch.stack([mx, my, mz], dim=-2)


def con_y(v):
    """Orthonormal frame with y-row parallel to v (m3d_s_con_y, reference
    src/vectors.h:325-332)."""
    my = normalize(v)
    mz = con(v)
    mx = cross(my, mz)
    return torch.stack([mx, my, mz], dim=-2)


# --------------------------------------------------------------------------
# rays


def ray_pos(p, d, offs):
    """Point along ray: p + offs * d (ray_s_pos, reference
    src/vectors.h:348-351)."""
    return p + d * offs[..., None]


# --------------------------------------------------------------------------
# sphere sampling (Archimedes cap/belt, reference src/vectors.h:192-218)


def sphere_cap_sample(u_phi, u_z, h):
    """Uniform direction on a spherical cap of height h around +z.
    u_phi, u_z are uniforms in [0,1); h broadcastable.
    (v3d_s_random_sphere_cap, reference src/vectors.h:197-206)."""
    phi = (2.0 * math.pi) * u_phi
    z = 1.0 - u_z * h
    # sqrt(max(x, 0)) whose gradient is 0, not infinite, where x <= 0 (at
    # u_z = 0 the pole z = 1; the differentiable renderer takes the
    # gradient with respect to h)
    x = 1.0 - z * z
    pos = x > 0
    scale = torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)
    return torch.stack([torch.sin(phi) * scale, torch.cos(phi) * scale,
                        z], dim=-1)


def sphere_belt_sample(u_phi, u_z, h):
    """Uniform direction on the symmetric belt |z| <= h
    (v3d_s_random_sphere_belt, reference src/vectors.h:209-218).
    u_z in [0,1) maps to z in (-h, h)."""
    phi = (2.0 * math.pi) * u_phi
    z = (2.0 * u_z - 1.0) * h
    scale = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([torch.sin(phi) * scale, torch.cos(phi) * scale,
                        z], dim=-1)


def saturate_color(c, gamma):
    """Gamma then clamp to [0,1] per channel (cl_s_sat, reference
    src/vectors.h:372-384)."""
    x = torch.pow(torch.clamp(c, min=0.0), gamma)
    return torch.clamp(x, 0.0, 1.0)
