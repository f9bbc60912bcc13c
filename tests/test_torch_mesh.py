"""The port's multi-device rendering (actinon_tpu_torch/parallel/mesh.py)
on the CPU: worlds of gloo worker processes against the single-device
drain and differentiable renderer, with the bounds of the JAX package's
tests/test_mesh.py, test_path_device.py:68, test_accounting.py:84 and
test_multihost.py; and the port's 2-rank ShardedIntegrator against the
JAX package's on a 2-device virtual mesh, in f64 counter mode, at the
tolerances of tests/test_torch_integrator.py."""

import numpy as np
import pytest
import torch

from _torch_mesh import glass_table, launch, pixel_centres, single_diff, \
    single_drain, single_queue
from _torch_threads import one_torch_thread  # noqa: F401

# glass_table at (w, h, direct, path, depth)
DRAIN = dict(kind="drain", shape=(16, 12, 3, 0, 6), dtype="float32",
             batch=512)
NONDIV = dict(DRAIN, shape=(7, 5, 3, 0, 6), batch=128)
MIXED = dict(DRAIN, shape=(8, 6, 2, 2, 12))
DIFF = dict(kind="diff", shape=(16, 8, 3, 0, 5), dtype="float32",
            lanes=128, steps=4)
# an arbitrary primary queue: the host drain on each rank's rows
QUEUE = dict(DRAIN, kind="queue", shape=(12, 9, 3, 0, 6), batch=256)
JOBS2 = {"drain": DRAIN, "nondiv": NONDIV, "mixed": MIXED, "diff": DIFF,
         "queue": QUEUE}
JOBS3 = {"drain": DRAIN, "nondiv": NONDIV}
# the slice against the JAX package: f64, counter seeding
VS_JAX = dict(DRAIN, shape=(10, 8, 2, 0, 5), dtype="float64", batch=128,
              seed_mode="counter")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return launch(dict(JOBS2, vs_jax=VS_JAX), 2,
                  tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return launch(JOBS3, 3, tmp_path_factory.mktemp("world3"))


@pytest.fixture(scope="module")
def singles():
    return {name: single_drain(job) for name, job in
            (("drain", DRAIN), ("nondiv", NONDIV), ("mixed", MIXED))}


def test_world_of_one_equals_run_device():
    """At world size 1 the interleave is the identity and the sharded
    drain is run_device's own, bit for bit."""
    from actinon_tpu_torch.parallel.mesh import ShardedIntegrator, make_mesh
    from actinon_tpu_torch.render.integrator import Integrator
    from _torch_mesh import _tracer
    mesh = make_mesh(1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
    sh = ShardedIntegrator(_tracer(DRAIN), mesh, batch=DRAIN["batch"])
    single = Integrator(_tracer(DRAIN), batch=DRAIN["batch"])
    pos = pixel_centres(sh.cfg)
    acc_sh = sh.run_samples(pos)
    acc_1 = single.run_device(None, len(pos), pos_xy=pos)
    assert np.array_equal(acc_sh, acc_1)
    assert sh.rays_traced == single.rays_traced
    assert sh.last_trips == single.last_trips and sh.last_balance == 1.0
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError):
        make_mesh(device="cpu", backend="nccl")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["drain", "nondiv"])
def test_sharded_drain_matches_single(n, name, world2, world3, singles):
    """test_mesh.py:46 and :52-69: within 2e-5 of the single-device
    drain, 7x5 not divisible by the rank count included."""
    res = (world2 if n == 2 else world3)[0][name]
    acc_1, _ = singles[name]
    assert res["acc"].shape == acc_1.shape
    assert np.isfinite(res["acc"]).all()
    assert np.abs(res["acc"] - acc_1).max() < 2e-5
    assert 0 < float(res["balance"]) <= 1.0
    if name == "nondiv":
        assert len(acc_1) % n != 0


def test_mixed_path_drain_sharded(world2, singles):
    """test_path_device.py:68-95: the mixed path drain sharded over 2
    ranks, mean within 1e-5 and max within 1e-2."""
    acc_sh = world2[0]["mixed"]["acc"]
    acc_1, _ = singles["mixed"]
    assert np.isfinite(acc_sh).all()
    assert abs(acc_sh.mean() - acc_1.mean()) < 1e-5
    assert np.abs(acc_sh - acc_1).max() < 1e-2


def test_sharded_queue_matches_single_run(world2):
    """ShardedIntegrator.run_device(primary, n) on an arbitrary queue (the
    JAX package's mesh.py:91-104 branch: the host drain, here on each
    rank's round-robin share of the rows) against a single run() of the
    host drain, within tests/test_mesh.py's 2e-5, with its queries;
    every rank holds the same image."""
    acc_1, rays_1 = single_queue(QUEUE)
    for rank in world2:
        got = rank["queue"]
        assert got["acc"].shape == acc_1.shape
        assert np.isfinite(got["acc"]).all() and acc_1.max() > 0
        assert np.abs(got["acc"] - acc_1).max() < 2e-5
        assert int(got["rays_traced"]) == rays_1 > 0
        assert 0.5 < float(got["balance"]) <= 1.0
    assert np.array_equal(world2[0]["queue"]["acc"],
                          world2[1]["queue"]["acc"])


@pytest.mark.parametrize("name", ["drain", "mixed"])
def test_sharded_accounting(name, world2, singles):
    """test_accounting.py:84-103: the sharded drain traces the single
    drain's queries."""
    _, rays_1 = singles[name]
    for rank in world2:
        assert int(rank[name]["rays_traced"]) == rays_1 > 0


@pytest.mark.parametrize("name", ["drain", "nondiv", "mixed"])
def test_every_rank_returns_the_full_image(name, world2, world3):
    """test_multihost.py:61: every rank holds the same full image."""
    for world in (world2, world3):
        if name not in world[0]:
            continue
        for rank in world[1:]:
            assert np.array_equal(rank[name]["acc"], world[0][name]["acc"])


def test_sharded_backward_matches_single(world2):
    """test_mesh.py:72-103: ShardedDiffRenderer over 2 ranks against
    value_and_grad on one device."""
    want = single_diff(DIFF)
    for rank in world2:
        got = rank["diff"]
        assert set(got) == set(want)
        assert abs(float(got["loss"]) - float(want["loss"])) < 1e-5
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=2e-5, err_msg=k)
    assert np.array_equal(world2[0]["diff"]["loss"],
                          world2[1]["diff"]["loss"])


def test_sharded_matches_jax_sharded(world2):
    """The slice against the JAX package: the port's 2-rank
    ShardedIntegrator against the JAX package's ShardedIntegrator on a
    2-device virtual mesh, glass_table in f64, counter seeding (sample
    ids are local to the shard on both sides)."""
    from actinon_tpu.acn.interp import run_file
    from actinon_tpu.parallel.mesh import ShardedIntegrator, make_mesh
    from actinon_tpu.render.tracer import Tracer
    from actinon_tpu.scene import ir as sir
    sc = glass_table(run_file, *VS_JAX["shape"])
    sh = ShardedIntegrator(Tracer(sir.compile_scene(sc), dtype=np.float64),
                           make_mesh(2), batch=VS_JAX["batch"])
    sh.seed_mode = "counter"
    want = sh.run_samples(pixel_centres(sc.cfg))
    got = world2[0]["vs_jax"]
    np.testing.assert_allclose(got["acc"], want, rtol=1e-6, atol=1e-9)
    assert want.max() > 0
    assert int(got["rays_traced"]) == sh.rays_traced
