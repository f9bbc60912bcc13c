"""Carrying parameters across from the JAX package.

A render's parameters — the geometry of its leaves and its material and
light tables — are the port's counterpart of a model's weights.
`load_jax_params` takes them as the JAX package exports them
(`Tracer.geom_params()`, `Integrator.mat_params()`, converted to numpy)
and writes them into the port's tables, so the two packages compute with
the same numbers.  Nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_jax_params(tracer, integ, geom: Dict[str, np.ndarray],
                    mat: Dict[str, np.ndarray]):
    """Write JAX `geom_params()` / `mat_params()` dicts (numpy arrays,
    same keys) into the port's `tracer` and `integ`.  Raises KeyError on a
    key the port does not have, and ValueError on a shape that differs
    from the port's own table."""
    own_g = tracer.geom_params()
    own_m = integ.mat_params()
    for own, given in ((own_g, geom), (own_m, mat)):
        for k, v in given.items():
            if k not in own:
                raise KeyError(f"unknown parameter {k!r}")
            if np.shape(v) != np.shape(own[k]):
                raise ValueError(f"{k}: shape {np.shape(v)} != "
                                 f"{np.shape(own[k])}")
    tracer.set_geom({k: np.asarray(v) for k, v in geom.items()})
    integ.set_mat({k: np.asarray(v) for k, v in mat.items()})
