"""Global numeric policy and the render configuration record.

The reference computes everything in f64 (`f3_t`, reference src/vectors.h:30-33)
with a hard-coded surface-shell epsilon of 1e-6.  On the GPU the fast dtype
is f32, so the epsilon scales with the dtype: the shell just has to be a few
ulps at scene scale.  Nothing here reads global state: every entry point of
the package takes its dtype as an argument.

`RenderConfig` mirrors the `scene_s` reflective config record and its default
values (reference src/scene.c:185-213) so that reference `.acn` scenes assign
fields 1:1 (e.g. ``scene.trace_depth = 25;``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

F3_MAG = 1e30   # "very large number" (reference src/vectors.h:32)


@dataclasses.dataclass(frozen=True)
class FType:
    """Numeric policy: dtype + the matching surface-shell epsilon."""

    dtype: np.dtype
    eps: float

    @property
    def np(self):
        return self.dtype

    @staticmethod
    def f64() -> "FType":
        return FType(dtype=np.dtype(np.float64), eps=1e-6)

    @staticmethod
    def f32(eps: float = 1e-4) -> "FType":
        # 1e-4 is a few hundred f32-ulps at coordinate magnitude ~10, the
        # scale of all reference scenes; plays the role of f3_eps=1e-6 in f64.
        return FType(dtype=np.dtype(np.float32), eps=eps)


@dataclasses.dataclass
class RenderConfig:
    """Render/camera configuration.

    Field names and defaults mirror `scene_s` (reference src/scene.c:185-213)
    so `.acn` scripts configure it by name.  `threads` is kept for script
    compatibility; it influences nothing (parallelism comes from
    the device mesh and batch size).
    """

    threads: int = 10
    image_width: int = 800
    image_height: int = 600
    gamma: float = 1.0
    gradient_threshold: float = 0.1
    gradient_samples: int = 10
    gradient_cycles: int = 1

    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    camera_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_view_direction: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_top_direction: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_focal_length: float = 1.0

    trace_depth: int = 11
    trace_min_intensity: float = 0.0
    direct_samples: int = 100
    path_samples: int = 0
    max_path_length: float = F3_MAG

    experimental_level: int = 0

    # --- framework extensions (not in the reference record) ---
    # ray batch size per device per wavefront step
    batch_rays: int = 1 << 15

    _FIELD_NAMES = None  # filled in below

    def set_field(self, name: str, value):
        """Reflective field assignment, the `bcore_via` analog
        (reference src/interpreter.c:1486-1496)."""
        if name not in self.field_names():
            raise KeyError(name)
        f = {f.name: f for f in dataclasses.fields(self)}[name]
        if f.type in ("int", int):
            value = int(value)
        elif f.type in ("float", float):
            value = float(value)
        setattr(self, name, value)

    def get_field(self, name: str):
        if name not in self.field_names():
            raise KeyError(name)
        return getattr(self, name)

    @classmethod
    def field_names(cls):
        if cls._FIELD_NAMES is None:
            cls._FIELD_NAMES = {f.name for f in dataclasses.fields(cls)
                                if not f.name.startswith("_")}
        return cls._FIELD_NAMES


def resolve_device(device) -> "torch.device":
    """The torch device an entry point runs on.  `cuda` is the default of
    every entry point; asking for it without a card raises instead of
    quietly running on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
