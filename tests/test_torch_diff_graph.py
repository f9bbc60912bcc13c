"""The differentiable renderer's replay as DiffGraphs captures it, on the
CPU (render/graphs.py replays it as one CUDA graph on a card).

  * Nothing read back: the loss and its backward (`DiffRenderer._share`,
    what the capture records) on the `meta` device, which holds no data,
    so a host read raises there; the dispatch and function modes of
    tests/_torch_capture.py see no upload, no tensor made from a host
    value and no op that reads the device back.  The parameter values' upload into the graph's leaves happens
    outside the capture, so the leaves are made before.
  * Bit-equal with reads off: with `host_reads_ok` False (the replay
    runs every bounce and every NEE, as under capture) the loss and every
    gradient equal those of the early-stopping replay bit for bit, in f64
    on the scenes of test_torch_diff.py's AGREE; `tracer.no_host_reads`,
    which a graph's warm-up runs under, turns them off the same way.
  * One graph for every parameter value: value_and_grad at given values
    equals the call after set_geom/set_mat to them bit for bit, and the
    digest of what the replay reads besides its leaves
    (render/graphs.py `_statics`) stays; it moves with an SDF object's
    frame and, with edge_aware, with the leaf table.
The no-read replay against the jitted JAX value_and_grad is in
test_torch_diff.py (test_no_read_replay_matches_jax), which computes the
JAX values once for its module."""

import numpy as np
import pytest
import torch

from _torch_capture import _Reads, _Scalars, _Uploads
from _torch_diff import port_setup
from actinon_tpu_torch.render import diff as diff_mod
from actinon_tpu_torch.render import graphs
from actinon_tpu_torch.render import tracer as tracer_mod

AGREE = [("plain", "uniform"), ("glass", "balanced"), ("lens", "uniform"),
         ("path", "balanced")]

# (scene, sel_mode): AGREE, an SDF object (the march's reads), and three
# edge-aware scenes (the silhouette terms: the nodes of an ellipsoid and a
# cylinder occluder; an ellipsoid lamp's detached hits)
META = AGREE + [("torus", "balanced"), ("edge_ellipsoid", "uniform"),
                ("edge_cylinder", "uniform"),
                ("edge_ellipsoid_light", "uniform")]


def _leaves(dr):
    return {g: {k: v.detach().requires_grad_(True) for k, v in grp.items()}
            for g, grp in dr.params().items()}


@pytest.mark.parametrize("name,sel_mode", META,
                         ids=[f"{n}-{s}" for n, s in META])
def test_replay_reads_nothing_back(name, sel_mode):
    """One loss and backward on the meta device in f32 over two bounces
    (a bounce's ops do not depend on its index): no host read (the
    parent's replay raised at its early stop), no upload, no host value
    made a tensor, and every bounce replayed."""
    dr, q0 = port_setup(name, sel_mode, edge_aware=name.startswith("edge"),
                        dtype=np.float32, device="meta")
    assert not dr.diff_graphs
    q = dr._lanes(q0)
    dr.n_steps = 1
    dr._share(_leaves(dr), q)         # fills the tracer's device constants
    dr.n_steps = 2
    leaves = _leaves(dr)
    seen, scalars, reads = _Uploads(), _Scalars(), _Reads()
    with seen, scalars, reads:
        loss, grads = dr._share(leaves, q)
    assert seen.seen == [] and scalars.seen == [] and reads.seen == []
    assert loss.device.type == "meta" and dr.steps_run == dr.n_steps
    assert {g: set(v) for g, v in grads.items()} == \
        {g: set(v) for g, v in leaves.items()}
    with pytest.raises(RuntimeError, match="meta"):
        bool(loss > 0)


def _no_reads(monkeypatch):
    monkeypatch.setattr(diff_mod, "host_reads_ok", lambda device: False)
    monkeypatch.setattr(tracer_mod, "host_reads_ok", lambda device: False)


@pytest.mark.parametrize("name,sel_mode", AGREE,
                         ids=[f"{n}-{s}" for n, s in AGREE])
def test_no_read_replay_bit_equal(monkeypatch, name, sel_mode):
    """The replay with host reads off against the early-stopping replay
    on the CPU: the same loss and gradients bit for bit; the early stop
    fires with reads on, and every bounce runs with them off.  The CPU
    runs no graph."""
    dr, q0 = port_setup(name, sel_mode)
    want = dr.value_and_grad(q0)
    assert dr.steps_run < dr.n_steps
    _no_reads(monkeypatch)
    got = dr.value_and_grad(q0)
    assert dr.steps_run == dr.n_steps
    assert dr._graphs is None
    assert torch.equal(got[0], want[0]) and float(want[0]) > 0
    for g, grp in want[1].items():
        for k, v in grp.items():
            assert torch.equal(got[1][g][k], v), (g, k)


def _equal(got, want):
    assert torch.equal(got[0], want[0])
    for g, grp in want[1].items():
        for k, v in grp.items():
            assert torch.equal(got[1][g][k], v), (g, k)


def test_no_host_reads_runs_every_bounce():
    """Within `no_host_reads` (a graph's warm-up) the replay reads
    nothing back on the CPU too: every bounce runs, and the loss and
    gradients equal the early-stopping replay's bit for bit."""
    dr, q0 = port_setup("glass", "balanced")
    want = dr.value_and_grad(q0)
    assert dr.steps_run < dr.n_steps
    with tracer_mod.no_host_reads():
        assert not tracer_mod.host_reads_ok(torch.device("cpu"))
        got = dr.value_and_grad(q0)
    assert dr.steps_run == dr.n_steps
    assert tracer_mod.host_reads_ok(torch.device("cpu"))
    _equal(got, want)


def _moved(params, scale=1.001):
    return {g: {k: v.cpu().numpy() * scale for k, v in grp.items()}
            for g, grp in params.items()}


@pytest.mark.parametrize("name,sel_mode", AGREE,
                         ids=[f"{n}-{s}" for n, s in AGREE])
def test_params_argument_equals_set_params(name, sel_mode):
    """value_and_grad at moved parameter values, passed as `params`,
    against the call after set_geom and set_mat to the same values: bit
    for bit, and the digest of what the replay reads besides its leaves
    is the same before and after, so a captured graph serves both."""
    dr, q0 = port_setup(name, sel_mode)
    own = dr.value_and_grad(q0)
    digest = graphs._statics(dr)
    moved = _moved(dr.params())
    got = dr.value_and_grad(q0, params=moved)
    assert not torch.equal(got[0], own[0])
    dr.tr.set_geom(moved["geom"])
    dr.integ.set_mat(moved["mat"])
    assert graphs._statics(dr) == digest
    _equal(got, dr.value_and_grad(q0))
    # a subset of the keys: the rest at the scene's own (now the moved)
    key = next(iter(moved["mat"]))
    _equal(got, dr.value_and_grad(q0, params={"mat": {
        key: moved["mat"][key]}}))
    with pytest.raises(KeyError):
        dr.value_and_grad(q0, params={"geom": {"nope": 1.0}})


def test_statics_follow_what_the_replay_reads():
    """The digest moves with a standalone SDF object's frame (the march
    runs on the tracer's own) and, with edge_aware, with any leaf of the
    tracer's table (the silhouette terms' detached queries), and not
    with a material table."""
    dr, _ = port_setup("torus", "balanced")
    digest = graphs._statics(dr)
    moved = _moved(dr.params())
    dr.integ.set_mat(moved["mat"])
    assert graphs._statics(dr) == digest
    dr.tr.set_geom(moved["geom"])
    assert graphs._statics(dr) != digest
    dr, _ = port_setup("edge_ellipsoid", "uniform", edge_aware=True)
    digest = graphs._statics(dr)
    dr.tr.set_geom(_moved(dr.params())["geom"])
    assert graphs._statics(dr) != digest
    dr.edge_aware = False
    assert graphs._statics(dr) == graphs._statics(
        port_setup("edge_ellipsoid", "uniform")[0])
