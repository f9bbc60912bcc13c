"""The device drain's trip as the CUDA-graph drain needs it, on the CPU.

`Integrator._trip` keeps every quantity on the device (render/graphs.py
captures it as a CUDA graph on the card): its compaction is a cumsum
scatter (`compact_rows`), which must equal the nonzero-order compaction
it replaced; one trip must read nothing back to the host and upload
nothing, which the `meta` device checks (it holds no data, so a host
read raises there) with a dispatch mode that sees every copy from the
host; and the whole drain must still equal the JAX package's
`run_device` in f64, in position and counter seeding and in the mixed
(path) drain, at tests/test_torch_integrator.py's contract."""

import os

import numpy as np
import pytest
import torch

from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.acn.interp import run_file
from actinon_tpu_torch.render.integrator import Integrator as TIntegrator
from actinon_tpu_torch.render.integrator import compact_rows
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho

from _torch_capture import _Reads, _Scalars, _Uploads
from test_torch_integrator import make_scene, sample_pos

GLASS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "actinon_tpu_torch", "scenes",
    "glass_table.acn")


@pytest.mark.parametrize("n,p,room", [(96, 0.3, 1000), (96, 0.5, 20),
                                      (200, 0.9, 0), (64, 0.0, 50),
                                      (64, 1.0, 64)],
                         ids=["fits", "overflow", "full", "empty", "all"])
def test_compact_rows_equals_nonzero_order(n, p, room):
    """Slots hold the kept rows in order (nonzero's order) up to the
    room, dead past it; nv and nv_fit count them."""
    rng = np.random.default_rng(n + room)
    mask = torch.as_tensor(rng.uniform(size=n) < p)
    src, live, nv, nv_fit = compact_rows(mask, torch.tensor(room))
    want = torch.nonzero(mask).squeeze(1)
    k = min(len(want), room)
    assert int(nv) == len(want) and int(nv_fit) == k
    assert torch.equal(src[:k], want[:k])
    assert torch.equal(live, torch.arange(n) < k)
    assert int(src.min()) >= 0 and int(src.max()) < n


_GLASS = []


def glass_table(w=8, h=6, direct=2, path=0, depth=4):
    if not _GLASS:
        run_file(GLASS, render_fn=lambda sc, fn: _GLASS.append(sc.clone()),
                 args=["-f"])
    sc = _GLASS[0].clone()
    sc.cfg.image_width, sc.cfg.image_height = w, h
    sc.cfg.direct_samples, sc.cfg.path_samples = direct, path
    sc.cfg.trace_depth = depth
    return sc


@pytest.mark.parametrize("scene,mode", [
    ("glass_table", "position"), ("glass_table", "counter"),
    ("glass_path", "position")])
def test_trip_reads_nothing_back(scene, mode):
    """One trip of a tiny batch on the meta device: a host read (the NEE
    gate's any(), a nonzero, the count) raises there, the dispatch mode
    sees no copy from the host, and the function mode no tensor made from
    a host value.  The parent's trip stopped at its NEE gate
    (`bool(di_gate.any())`)."""
    sc = glass_table(path=4, depth=12) if scene == "glass_path" \
        else glass_table()
    integ = TIntegrator(TTracer(tsir.compile_scene(sc), dtype=np.float32,
                                device="meta"), batch=64)
    integ.seed_mode = mode
    assert not integ.drain_graphs
    pos = torch.zeros((64, 2), dtype=torch.float32, device="meta")
    C, size = integ._queue_size(64, 64)
    st = integ._drain_state(C, size)
    integ._fill_state(st, integ._pos_rows(pos, 48), 48)
    integ._trip(st, 64)          # fills the tracer's device constants
    seen, scalars, reads = _Uploads(), _Scalars(), _Reads()
    with seen, scalars, reads:
        integ._trip(st, 64)
    assert seen.seen == [] and scalars.seen == [] and reads.seen == []
    with pytest.raises(RuntimeError, match="meta"):
        int(st["count"])
    # the detectors see an upload, a host scalar made a tensor, and a
    # host value written into a tensor
    with seen, scalars:
        torch.as_tensor(np.ones(3), device="meta")
        torch.as_tensor(5, device="meta")
        st["acc"][0, 0] = 1.0
    assert seen.seen and len(scalars.seen) == 3


def _pair(mode, **kw):
    jt = JTracer(jsir.compile_scene(make_scene(jho, **kw)),
                 dtype=np.float64)
    tt = TTracer(tsir.compile_scene(make_scene(tho, **kw)),
                 dtype=np.float64, device="cpu")
    ji, ti = JIntegrator(jt, batch=64), TIntegrator(tt, batch=64)
    ji.seed_mode = ti.seed_mode = mode
    return ji, ti


@pytest.mark.parametrize("mode,kw", [
    ("position", dict(direct_samples=2, depth=6)),
    ("counter", dict(direct_samples=2, depth=6)),
    ("counter", dict(direct_samples=2, path_samples=2, depth=11))],
    ids=["position", "counter", "mixed"])
def test_drain_matches_jax_run_device(mode, kw):
    """The port's drain against the JAX package's device-resident drain
    (one jitted while loop) in f64: the image and the queries, over
    trips of 64 lanes."""
    ji, ti = _pair(mode, **kw)
    pos = sample_pos(ji.cfg, 64)
    want = ji.run_device(None, len(pos), pos_xy=pos)
    got = ti.run_device(None, len(pos), pos_xy=pos)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert ti.rays_traced == ji.rays_traced
    assert ti.last_trips > 1
