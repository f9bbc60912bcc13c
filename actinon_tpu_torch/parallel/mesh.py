"""Multi-device rendering: data parallelism over camera samples.

PyTorch counterpart of the JAX package's `parallel/mesh.py`.  The
reference's only parallel axis is pixel samples over a thread pool
(reference src/scene.c:906-1028); here it is one process per device,
joined by `torch.distributed` (NCCL between CUDA devices, gloo on the
CPU), as a launcher such as `torchrun` starts them:

  * `ShardedIntegrator` deals the camera samples round-robin over the
    ranks (rank k takes samples k, k+n, k+2n, ...: neighbouring pixels
    cost alike, so striding them balances the specular-depth load that
    contiguous blocks concentrate on a few ranks).  Each rank builds its
    primary rays on its device and drains its OWN queue with the
    single-device drain (`Integrator._drain`; children stay on their
    parent's rank, sample ids are local to the rank).  Independent
    processes need no agreement on trip counts inside the loop, so the
    only collectives run after the drain: an all-gather of the
    accumulators and one of each rank's (dropped, queries, trips).
    Every rank returns the full image.  An arbitrary primary queue
    (`run`, `run_device(primary, n)`) is dealt the same way by rows:
    each rank runs the host drain (`Integrator._run_host`) on its share
    into an accumulator of every sample, and the ranks' accumulators
    are all-gathered and summed in rank order.
  * `ShardedDiffRenderer` splits a primary batch into contiguous shares,
    differentiates each share's part of the mean loss, and sums the loss
    and every gradient in one all-reduce.  Every rank builds the same
    scene, so the parameters are replicated by construction.

Load balance is reported as the JAX package reports it:
`ShardedIntegrator.last_balance` = sum(queries) / (n * max(queries)),
with queries the live lanes each rank traced.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from actinon_tpu_torch.render.diff import DiffRenderer
from actinon_tpu_torch.render.integrator import Integrator, RayQueue


@dataclasses.dataclass
class Mesh:
    """This process's place in the world: its rank, the world size, its
    device, the collectives' backend and the process group."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The mesh of this process.  A world that a launcher or the caller
    initialised is used as it is; otherwise this process starts a world
    of one (a FileStore in a temporary directory: no port to race for).
    `device` "cuda" means cuda:$LOCAL_RANK (0 when unset); the backend is
    NCCL for CUDA and gloo for the CPU unless `backend` names another
    (gloo over CUDA devices: several ranks sharing one card, the
    collectives through the host).  A world whose backend differs from
    the one asked for, or whose size differs from n_devices, raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        store = dist.FileStore(
            os.path.join(tempfile.mkdtemp(prefix="actinon_mesh_"), "store"),
            1)
        kw = dict(device_id=dev) if want == "nccl" else {}
        dist.init_process_group(want, store=store, rank=0, world_size=1,
                                **kw)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"make_mesh: the world runs {have}, not {want}")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"world has {size}")
    return Mesh(rank=dist.get_rank(), size=size, device=dev, backend=have,
                group=dist.group.WORLD)


def _all_gather(mesh: Mesh, x: torch.Tensor):
    """x from every rank, in rank order (on x's device).  gloo gathers
    host tensors, so CUDA tensors cross through the host there."""
    host = mesh.backend == "gloo" and x.device.type != "cpu"
    y = x.cpu() if host else x.contiguous()
    out = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(out, y, group=mesh.group)
    return [o.to(x.device) for o in out] if host else out


def _all_reduce_sum(mesh: Mesh, x: torch.Tensor):
    host = mesh.backend == "gloo" and x.device.type != "cpu"
    y = x.cpu() if host else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y.to(x.device)


class ShardedIntegrator(Integrator):
    """Integrator whose drains are sharded over the ranks of `mesh`:
    run_samples() and run_device(None, n, pos_xy) deal the camera samples
    round-robin, drain each rank's share on the device and gather the
    full image on every rank (path configs through the mixed drain);
    run() and run_device(primary, n) deal a primary queue's rows the same
    way and run the host drain on each share."""

    def __init__(self, tracer, mesh: Mesh, batch: int = 1 << 16):
        self.mesh = mesh
        # every rank's trips take at least 64 lanes
        batch = max(batch, mesh.size * 64)
        super().__init__(tracer, batch=batch)
        self.last_balance = None

    def run_samples(self, pos_xy: np.ndarray) -> np.ndarray:
        # path configs run the mixed-kind drain (parents expand in place
        # on their own rank), so every workload shards the same way
        return self._run_sharded(np.asarray(pos_xy))

    def run_device(self, primary: Optional[RayQueue], n_samples: int,
                   pos_xy: Optional[np.ndarray] = None) -> np.ndarray:
        if pos_xy is not None:
            return self._run_sharded(np.asarray(pos_xy))
        # arbitrary primary queues (not camera samples): the host drain
        # on each rank's share of the rows
        return self.run(primary, n_samples)

    def run(self, primary: RayQueue, n_samples: int,
            progress=None) -> np.ndarray:
        if not isinstance(primary, RayQueue):
            raise TypeError("primary queue required")
        n, k = self.mesh.size, self.mesh.rank
        share = RayQueue(*[getattr(primary, f.name)[k::n]
                           for f in dataclasses.fields(RayQueue)])
        B = max(64, self.batch // n)        # lanes per rank per step
        before = self.rays_traced
        acc = self._run_host(share, n_samples, B, progress)
        rays = torch.tensor([self.rays_traced - before], dtype=torch.int64,
                            device=self.device)
        accs = _all_gather(self.mesh, torch.as_tensor(acc,
                                                      device=self.device))
        rays = torch.cat(_all_gather(self.mesh, rays)).cpu().numpy()
        out = accs[0].clone()
        for a in accs[1:]:
            out += a                        # in rank order
        self.rays_traced = before + int(rays.sum())
        self.last_balance = float(rays.sum()) / max(1, n * int(rays.max()))
        return out.cpu().numpy()

    def _run_sharded(self, pos: np.ndarray) -> np.ndarray:
        n, k = self.mesh.size, self.mesh.rank
        N = len(pos)
        # samples per rank, bucketed to a power of two as run_device does
        Nl = 1 << int(np.ceil(np.log2(max(-(-N // n), 64))))
        Npad = Nl * n
        # rank k's samples k, k+n, k+2n, ...: a prefix of live samples
        # (sample j is global k + j*n, live while below N), dead behind
        idx = np.arange(Npad).reshape(Nl, n).T.reshape(-1)
        mine = idx[k * Nl:(k + 1) * Nl]
        pos_l = np.zeros((Nl, 2))
        live = mine < N
        pos_l[live] = pos[mine[live]]
        B = max(64, self.batch // n)        # lanes per rank per trip
        count = int(live.sum())
        acc, dropped, queries, trips = self._drain(
            self._pos_rows(self._as(pos_l), count), count, Nl, B)
        stats = torch.tensor([dropped, int(queries), trips],
                             dtype=torch.int64, device=acc.device)
        acc_sh = torch.cat(_all_gather(self.mesh, acc)).to(
            torch.float64).cpu().numpy()
        stats = torch.stack(_all_gather(self.mesh, stats)).cpu().numpy()
        out = np.empty_like(acc_sh)
        out[idx] = acc_sh                   # undo the interleave
        dropped, queries = int(stats[:, 0].sum()), stats[:, 1]
        trips = int(stats[:, 2].max())
        self.rays_traced += int(queries.sum()) * self.per_lane_queries
        self.last_trips = trips
        self.last_balance = float(queries.sum()) / max(
            1, n * int(queries.max()))
        self._drain_warnings(dropped, trips)
        return out[:N]


class ShardedDiffRenderer:
    """Forward and backward of a DiffRenderer's loss with the primary
    batch split over the ranks of `mesh`: each rank takes a contiguous
    share of the rows (`tensor_split`, so N need not divide), computes
    its share's part of the mean loss and its gradients, and one
    all-reduce sums the loss and every gradient.  Returns replicated
    (loss, grads) with the keys of DiffRenderer.params(), equal to the
    single-device result up to the order of the sums."""

    def __init__(self, diff_renderer: DiffRenderer, mesh: Mesh):
        self.dr = diff_renderer
        self.mesh = mesh

    def value_and_grad(self, q0, weight=None, params=None):
        """DiffRenderer.value_and_grad over the mesh (`params` as
        there)."""
        dr, n, k = self.dr, self.mesh.size, self.mesh.rank
        q = dr._lanes(q0)
        N = next(iter(q.values())).shape[0]
        q_l = {key: torch.tensor_split(v, n)[k] for key, v in q.items()}
        rows = next(iter(q_l.values())).shape[0]
        if rows:
            w = None
            if weight is not None:
                w = torch.tensor_split(torch.as_tensor(
                    weight, dtype=dr.integ.tdtype, device=dr.integ.device),
                    n)[k]
            # this share's part of torch.mean over the whole [N, 3] batch
            # (with diff_graphs the replay of a CUDA graph; the
            # all-reduce stays outside it)
            loss, grads = dr.share_value_and_grad(q_l, w, total=N,
                                                  params=params)
        else:
            loss = torch.zeros((), dtype=dr.integ.tdtype,
                               device=dr.integ.device)
            grads = {g: {key: torch.zeros_like(v) for key, v in grp.items()}
                     for g, grp in dr._at(params).items()}
        flat = torch.cat([loss.reshape(1)] + [
            v.reshape(-1) for grp in grads.values() for v in grp.values()])
        flat = _all_reduce_sum(self.mesh, flat)
        out, at = {}, 1
        for g, grp in grads.items():
            out[g] = {}
            for key, v in grp.items():
                out[g][key] = flat[at:at + v.numel()].reshape(v.shape)
                at += v.numel()
        return flat[0], out
