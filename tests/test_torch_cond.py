"""The device-side decisions of the captured paths (render/cond.py) on the
CPU: the JAX package's `lax.cond` and `lax.while_loop` as the port runs
them where the host may read the device, on the `meta` device and in a
capture's warm-up (a CUDA graph records them as conditional nodes on a
card; tests/test_torch_cuda.py).

  * The drain's cascade of stage loops (`Integrator._drain`,
    `_stage_loop`) against the loop it replaced, a trip and a host read
    at a time: the same trips, stage sequence, accumulator bits, queries
    and dropped, in position and counter seeding and the mixed (path)
    drain, over two stages; the cascade over all three stages of a
    32,768-lane batch and the trip cap with a scripted trip.
  * The gated NEE under autograd (`Integrator._nee_gated`,
    `cond.cond_grad`): with its gate false, stale NaN inputs reach no
    gradient, which equals the ungated replay's bit for bit; the
    ungated NEE's backward makes them NaN.
  * Nothing read back: a stage loop (one pass of its body) on the meta
    device under tests/_torch_capture.py's detectors, with an SDF march
    (its while loop) among them.
  * `if_node`, `while_loop` and `Gates` themselves: host decisions, the
    warm-up's unread bodies and their launch counts."""

import numpy as np
import pytest
import torch

from _torch_capture import _Reads, _Scalars, _Uploads
from _torch_diff import make_scene, port_setup, torus_scene
from actinon_tpu_torch.render import cond, kernels
from actinon_tpu_torch.render import integrator as integ_mod
from actinon_tpu_torch.render.integrator import Integrator
from actinon_tpu_torch.render.tracer import Tracer, no_host_reads
from actinon_tpu_torch.scene import ir as sir
from actinon_tpu_torch.scene import objects as tho
from test_torch_integrator import sample_pos


def _integ(mode, batch, device="cpu", build=make_scene, **kw):
    integ = Integrator(Tracer(sir.compile_scene(build(tho, **kw)),
                              dtype=np.float32, device=device),
                       batch=batch)
    integ.seed_mode = mode
    return integ


def per_trip(integ, rows, count, Np, B):
    """The drain loop the stage loops replaced: a trip at a time, the
    host reading the count after each to choose the next stage."""
    C, size = integ._queue_size(Np, B)
    st = integ._drain_state(C, size)
    integ._fill_state(st, rows, count)
    stages = integ._stages(B)
    k, trips = 0, 0
    while count > 0 and trips < integ_mod.DRAIN_TRIP_CAP:
        while k + 1 < len(stages) and count <= stages[k + 1]:
            k += 1
        integ._trip(st, stages[k])
        trips += 1
        count = int(st["count"])
    return (st["acc"][:Np].clone(), int(st["dropped"]),
            st["queries"].clone(), trips)


def _logged(integ, trip=None):
    """Record each trip's batch size (and run `trip` in place of it)."""
    log, orig = [], trip or integ._trip

    def spy(st, Bk):
        log.append(Bk)
        return orig(st, Bk)

    integ._trip = spy
    return log


@pytest.mark.parametrize("mode,kw,n", [
    ("position", dict(direct_samples=2, depth=6, glass=True, lens=True),
     1200),
    ("counter", dict(direct_samples=2, depth=6, glass=True, lens=True),
     1200),
    ("counter", dict(direct_samples=2, path_samples=2, depth=11), 700)],
    ids=["position", "counter", "mixed"])
def test_stage_loops_equal_per_trip_loop(mode, kw, n):
    """2048-lane trips (stages 2048 and 512) over n samples of the glass
    ball and lens scene (the mixed drain: the plain scene's path
    children): the stage loops and the per-trip loop run the same trips
    in the same stages to the same state, bit for bit."""
    integ = _integ(mode, 2048, **kw)
    Np = 1 << int(np.ceil(np.log2(n)))
    pos = torch.zeros((Np, 2), dtype=torch.float32)
    pos[:n] = torch.as_tensor(sample_pos(integ.cfg, n), dtype=torch.float32)
    log = _logged(integ)
    want = per_trip(integ, integ._pos_rows(pos, n), n, Np, 2048)
    want_seq, log[:] = list(log), []
    got = integ._drain(integ._pos_rows(pos, n), n, Np, 2048)
    assert log == want_seq and set(want_seq) == {2048, 512}
    assert torch.equal(got[0], want[0]) and float(want[0].sum()) > 0
    assert got[1] == want[1] and got[3] == want[3]
    assert torch.equal(got[2], want[2])
    assert integ.last_host_reads == 2         # once a stage


def _scripted_trip(st, Bk):
    """A trip that takes Bk lanes and leaves 3/5 of them as children."""
    count = st["count"]
    take = torch.clamp(count, max=Bk)
    count.copy_(count - take + (take * 3) // 5)
    st["queries"].add_(take)


@pytest.mark.parametrize("cap", [integ_mod.DRAIN_TRIP_CAP, 7])
def test_cascade_crosses_every_stage(monkeypatch, cap):
    """A 32,768-lane drain (stages 32768, 4096, 512) of 100,000 rows with
    a scripted trip: the stage loops run the per-trip loop's stages in
    its order, and stop at the trip cap with it."""
    monkeypatch.setattr(integ_mod, "DRAIN_TRIP_CAP", cap)
    integ = _integ("position", 1 << 15)
    log = _logged(integ, _scripted_trip)
    n = 100000
    Np = 1 << 17
    rows = {"sample_id": torch.zeros(1, dtype=torch.int64)}
    want = per_trip(integ, rows, n, Np, 1 << 15)
    want_seq, log[:] = list(log), []
    got = integ._drain(rows, n, Np, 1 << 15)
    assert log == want_seq
    assert got[3] == want[3] == min(cap, len(want_seq))
    assert torch.equal(got[2], want[2])
    if cap > 7:
        assert sorted(set(log), reverse=True) == [32768, 4096, 512]
        assert integ.last_host_reads == 3
        assert log == sorted(log, reverse=True)


def _diff_state(dr):
    """The overrides DiffRenderer.radiance sets, on leaves."""
    integ, tr = dr.integ, dr.tr
    leaves = {g: {k: v.detach().requires_grad_(True) for k, v in grp.items()}
              for g, grp in dr.params().items()}
    integ.ovr, tr.ovr = dict(leaves["mat"]), dict(leaves["geom"])
    tr.diff, integ.seed_mode = True, "counter"
    return leaves


def _nee_args(dr, B, fill):
    """NEE inputs of B lanes filled with `fill` (stale buffers), gate
    off: grad-requiring pos, surf_d, di, theta_i, on_a, on_b, ray_prj."""
    dt = dr.integ.tdtype
    vec = lambda: torch.full((B, 3), fill, dtype=dt).requires_grad_(True)
    lane = lambda: torch.full((B,), fill, dtype=dt).requires_grad_(True)
    return (vec(), vec(), lane(), torch.zeros(B, dtype=torch.bool), lane(),
            lane(), lane(), vec(), torch.zeros(B, dtype=torch.int64))


def _grads(leaves, args, lum):
    """Gradients of sum(lum) + sum of every leaf and NEE input."""
    flat = [v for grp in leaves.values() for v in grp.values()]
    flat += [a for a in args if a.requires_grad]
    loss = lum.sum() + sum(v.sum() for v in flat)
    return torch.autograd.grad(loss, flat, allow_unused=True)


def test_gated_nee_backward_skips_stale_nan():
    """A bounce where no lane shades diffusely: the gated NEE
    (`_nee_gated`) gives zeros, and its backward, gated on the same
    predicate, leaves every gradient as the ungated replay's (which
    masks the NEE with `where`) bit for bit, also when its inputs hold
    NaN; the ungated NEE's backward on those stale inputs makes NaN."""
    dr, _ = port_setup("plain", "uniform")
    integ = dr.integ
    leaves = _diff_state(dr)
    B = 8
    try:
        for fill in (0.5, float("nan")):
            args = _nee_args(dr, B, fill)
            lum = integ._nee_gated(*args)
            assert torch.equal(lum, torch.zeros_like(lum))
            got = _grads(leaves, args, lum)
            # (the tables built from the leaves: their graph is spent)
            dr.tr._ovr_tabs = integ._ovr_mats = None
            masked = torch.where(args[3][:, None], integ._nee(*args), 0.0)
            want = _grads(leaves, args, masked)
            assert all(torch.isfinite(g).all() for g in got)
            dr.tr._ovr_tabs = integ._ovr_mats = None
            if fill == fill:
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            else:
                assert all(torch.equal(g, torch.ones_like(g)) for g in got)
                assert not all(torch.isfinite(w).all() for w in want)
    finally:
        integ.ovr, dr.tr.ovr, dr.tr.diff = {}, {}, False
        dr.tr._ovr_tabs = integ._ovr_mats = None


@pytest.mark.parametrize("scene,mode", [
    ("plain", "position"), ("plain", "counter"), ("path", "counter"),
    ("torus", "position")])
def test_stage_loop_reads_nothing_back(scene, mode):
    """One pass of a stage loop's body (meta: the trip and the next
    predicate) reads nothing back and uploads nothing; the torus adds an
    SDF march, whose blocks run in a while loop of their own."""
    if scene == "torus":
        integ = _integ(mode, 64, device="meta", build=torus_scene)
    else:
        kw = dict(path_samples=2, depth=12) if scene == "path" else {}
        integ = _integ(mode, 64, device="meta", direct_samples=2, **kw)
    pos = torch.zeros((64, 2), dtype=torch.float32, device="meta")
    C, size = integ._queue_size(64, 64)
    st = integ._drain_state(C, size)
    integ._fill_state(st, integ._pos_rows(pos, 48), 48)
    integ._stage_loop(st, 64, 0)     # fills the tracer's device constants
    seen, scalars, reads = _Uploads(), _Scalars(), _Reads()
    with seen, scalars, reads:
        integ._stage_loop(st, 64, 0)
    assert seen.seen == [] and scalars.seen == [] and reads.seen == []


def test_if_node_and_while_loop_on_the_host():
    """With host reads: if_node reads its predicate, while_loop loops on
    it; within no_host_reads (a warm-up) if_node runs its body unread
    and counts its launches by the predicate on a Gates counter, and a
    while_loop runs its bound or raises."""
    x = torch.zeros(3, dtype=torch.int64)
    for flag in (False, True):
        with cond.if_node(torch.tensor(flag)) as run:
            assert run is flag
    cond.while_loop(lambda: x[0] < 5, lambda: x[0].add_(1))
    assert int(x[0]) == 5
    gates = cond.Gates(torch.device("cpu"))
    before = dict(kernels.LAUNCHES)
    with no_host_reads(), gates.collect():
        for flag in (True, False, True):
            with cond.if_node(torch.tensor(flag)) as run:
                assert run
                kernels.LAUNCHES["nee"] += 2
        cond.while_loop(lambda: x[1] < 0, lambda: x[1].add_(1), bound=4)
        with pytest.raises(RuntimeError, match="warm-up"):
            cond.while_loop(lambda: x[2] < 0, lambda: x[2].add_(1))
    assert kernels.LAUNCHES == before and int(x[1]) == 4
    gates.settle(gates.runs.numpy())
    assert kernels.LAUNCHES["nee"] == before["nee"] + 4
    gates.settle(gates.runs.numpy())          # nothing new
    assert kernels.LAUNCHES["nee"] == before["nee"] + 4
    kernels.LAUNCHES.update(before)
    with no_host_reads(), pytest.raises(RuntimeError, match="Gates"):
        with cond.if_node(torch.tensor(True)):
            kernels.LAUNCHES["nee"] += 1
    kernels.LAUNCHES.update(before)
