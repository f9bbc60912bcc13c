"""The comparison fails what it must, on the CPU: the control (the
reference computed in bfloat16 in the program's place) fails a committed
limit, and so does a run whose timed path is broken underneath (the card
check skipped, the rest of the run as it is)."""

import contextlib
import tempfile
import time

import numpy as np
import pytest
import torch

import harness

CELL = "cornell_box.frames"


def limits_failed(root, workload, per_unit):
    _, _, _, _, limits = harness.resolve(root, workload)
    return [n for got in per_unit for n, lim in limits.items()
            if not got[n] <= lim]


def test_control_fails(small_root):
    _, _, config, traffic, _ = harness.resolve(small_root, CELL)
    kind = harness.cell_kind(small_root, config, traffic, 41, "cpu")
    kind.setup(tempfile.gettempdir())
    kind.run_unit(0)
    kind.free()
    assert not limits_failed(small_root, CELL, kind.judge("cpu"))
    assert limits_failed(small_root, CELL, kind.judge("cpu", control=True))
    kind.close()


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def half_left_out(orig):
    """run_samples that traces the first half of its samples and gives
    the rest their mean."""
    def run_samples(integ, pos):
        n = len(pos) // 2
        out = orig(integ, pos[:n])
        return np.concatenate([out, np.broadcast_to(out.mean(0),
                                                    (len(pos) - n, 3))])
    return run_samples


def radiance_altered(orig):
    """run_samples with every fourth sample's radiance raised by 0.5."""
    def run_samples(integ, pos):
        out = orig(integ, pos)
        out[::4] += 0.5
        return out
    return run_samples


def stale_image(orig):
    """render_scene that returns its first image from then on."""
    first = []

    def render_scene(*a, **kw):
        img = orig(*a, **kw)
        if not first:
            first.append(img)
        return first[0]
    return render_scene


def image_altered(orig):
    """render_scene with one pixel raised by one 8-bit level."""
    def render_scene(*a, **kw):
        img = orig(*a, **kw).copy()
        img[0, 0] += 1 / 256
        return img
    return render_scene


def render_target():
    from actinon_tpu_torch.render import integrator
    return integrator.Integrator


def driver_target():
    from actinon_tpu_torch.render import driver
    return driver


FAULTS = [
    (render_target, "run_samples", half_left_out),
    (render_target, "run_samples", radiance_altered),
    (driver_target, "render_scene", stale_image),
    (driver_target, "render_scene", image_altered),
]


@pytest.mark.parametrize("target,name,fault", FAULTS,
                         ids=[f.__name__ for _, _, f in FAULTS])
def test_broken_path_is_not_correct(small_root, target, name, fault):
    with patched(target(), name, fault):
        result, _ = harness.run_cell(small_root, CELL, 23, 0.1, 0,
                                     time.perf_counter(), device="cpu")
    assert result["attempted"] >= 1
    assert not result["correct"]
    assert result["failed"] >= 1


def test_bf16_mode_rounds():
    import reference
    x = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    with reference.Bf16():
        y = x * 1.0
    assert float(y) == 1.0
    assert np.isclose(float(x * 1.0), 1.0 + 2.0 ** -12)
