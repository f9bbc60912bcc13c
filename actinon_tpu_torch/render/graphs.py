"""The device drain's stages, and the differentiable renderer's
value_and_grad, as replays of CUDA graphs.

The JAX package runs its whole device drain as one jitted cascade of
`lax.while_loop`s (its `run_device`), so a pass costs the host nothing
per trip.  Here a trip is `Integrator._trip`, a few hundred torch ops and
hand-written kernel launches that read nothing back to the host, and a
stage is `Integrator._stage_loop`, trips while the count exceeds the
next stage's batch.  `DrainGraphs` captures each stage into a
`torch.cuda.CUDAGraph` whose WHILE node (render/cond.py) runs its trips
on the device, and replays it: the host issues one graph launch a stage
and reads the count once a stage (`Integrator._drain`, which picks the
next stage from it), and the trips, their sizes and their order are
those of the eager drain.  Inside a trip the NEE runs under an IF node
(`Integrator._nee_gated`) and an SDF march under a WHILE node
(`Tracer._sdf_march`), as the JAX step's cond and while loop decide.

* Keys and buffers.  A drain's state (`Integrator._drain_state`: the
  queue, the accumulator, the count, trips, dropped, queries and the
  gated bodies' counters) is made once per queue shape (capacity C,
  rows) and kept, so that a graph's addresses hold; its accumulator has
  a row for every sample id the capacity admits, so passes with other
  sample counts share it.  A graph is keyed by that shape, the stage's
  batch Bk and its threshold; the graphs of one shape share one memory
  pool.
* Capture.  A key's first replay is preceded by a warm-up trip, run
  eagerly on a side stream (torch's warm-up recipe; it is a real trip of
  the drain, which the host knows runs, and it loads every kernel and
  fills every cache the trip reads), and the capture of the stage's loop
  (which runs nothing).  A capture that fails raises, and so does one
  where conditional nodes are unavailable (`cond.require`): there is no
  eager fallback.
* Lifetime.  Graphs are reused across drains and passes, and dropped with
  their state when the tracer's or the integrator's tables change
  (`Tracer.set_geom`, `Integrator.set_mat`: their `_generation`) or when
  a setting that routes the trip does (seed mode, kernels on or off).
  They live as long as their integrator, which `render_scene` keeps
  across calls that differ only in the camera (render/driver.py).
* Launch accounting.  `kernels.LAUNCHES` counts in the wrappers, which
  run only at capture.  Each graph keeps the launches its capture counted
  outside conditional bodies, and every replay adds them; a body's
  launches are added by the runs its device counter counted
  (`cond.Gates`), read with the stage's count; so `LAUNCHES` counts what
  the card ran.

`DiffGraphs` does the same for `DiffRenderer.value_and_grad`: one graph
holds the whole replay, the loss and its backward (its class docstring).
"""

from __future__ import annotations

import gc
import hashlib
import weakref
from types import SimpleNamespace

import numpy as np
import torch

from actinon_tpu_torch.render import cond, kernels, spans
from actinon_tpu_torch.render.diff import _LANE_FIELDS
from actinon_tpu_torch.render.tracer import no_host_reads


class _Captures:
    """torch's capture recipe, and what the captures cost: how many,
    their seconds, and the device memory the caching allocator reserved
    during them (their pools).  The owner (an integrator or a
    DiffRenderer) is held by a weak reference: no reference cycle keeps
    its graphs alive past it, for the cyclic collector to destroy later,
    perhaps in the middle of another capture, which that would
    invalidate."""

    def __init__(self, owner):
        self._owner = weakref.ref(owner)
        self._token = None
        self._drop()

    def _reset_costs(self):
        self.captures = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def _capture_fn(self, pool, fn, warm=None, rec=None):
        """warm() (default fn) once eagerly on a side stream with host
        reads off (the warm-up: it runs the ops that the capture records,
        so it loads every kernel and fills every cache they read), then
        fn captured into a new CUDA graph in `pool` (which runs nothing),
        its conditional nodes with it (render/cond.py).  Returns (graph,
        fn's captured outputs, the launches the capture counted outside
        conditional bodies: they move to the replays).  A capture that
        fails raises, and so does one where conditional nodes are
        unavailable.  With a record (render/spans.py): the spans
        graphs.capture, graphs.warmup and graphs.record (whose timer is
        `capture_s`'s), and the counters graphs.captures and
        graphs.pool_bytes."""
        with spans.span(rec, "graphs.capture"):
            cond.require()
            with spans.span(rec, "graphs.warmup"):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side), no_host_reads():
                    (warm or fn)()
                torch.cuda.current_stream().wait_stream(side)
            before = dict(kernels.LAUNCHES)
            with spans.Span(rec, "graphs.record") as timer:
                graph = torch.cuda.CUDAGraph()
                # a graph destroyed during the capture (the cyclic
                # collector freeing the caller's garbage) would invalidate
                # it
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with cond.capture(graph, pool):
                        # (read here: entering the capture empties the
                        # allocator's cache)
                        reserved = torch.cuda.memory_reserved()
                        out = fn()
                finally:
                    if collecting:
                        gc.enable()
                torch.cuda.synchronize()
        pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s += timer.seconds
        self.pool_bytes += pool_bytes
        self.captures += 1
        spans.count(rec, "graphs.captures")
        spans.count(rec, "graphs.pool_bytes", pool_bytes)
        launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                    if n != before[k]}
        kernels.LAUNCHES.update(before)
        return graph, out, launches


class DrainGraphs(_Captures):
    """The captured stages of one integrator's device drain."""

    @property
    def integ(self):
        return self._owner()

    def _drop(self):
        self._states = {}     # (C, rows) -> drain state
        self._pools = {}      # (C, rows) -> graph memory pool
        self._graphs = {}     # (C, rows, Bk, thresh) -> (graph, launches)
        self._reset_costs()

    def _routing(self):
        """What the captured trips depend on besides the drain state."""
        ig, tr = self.integ, self.integ.tr
        return (tr._generation, ig._generation, ig.seed_mode,
                ig.edge_aware, tr.use_kernels)

    def state(self, C, size):
        """The drain state of queue capacity C and `size` rows, made once
        (all graphs are dropped first when the routing changed)."""
        ig = self.integ
        if ig.ovr or ig.tr._traced():
            raise ValueError("the graph drain takes no overrides: set "
                             "drain_graphs = False")
        tok = self._routing()
        if tok != self._token:
            self._drop()
            self._token = tok
        key = (C, size)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = ig._drain_state(C, size)
            st["key"] = key
        return st

    def run(self, st, Bk, thresh):
        """Stage Bk's trips on the state `st` while its count exceeds
        `thresh`: the replay of the stage's graph, preceded at the key's
        first call by a warm-up trip (the host has just read that the
        stage runs) and the capture; with the integrator's record, a
        device span of the replay (render/spans.py)."""
        key = st["key"] + (Bk, thresh)
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = self._capture(st, Bk, thresh)
        graph, launches = got
        spans.replay(self.integ.record, graph, Bk)
        self.replays += 1
        for k, n in launches.items():
            kernels.LAUNCHES[k] += n

    def _capture(self, st, Bk, thresh):
        pool = self._pools.get(st["key"])
        if pool is None:
            pool = self._pools[st["key"]] = torch.cuda.graph_pool_handle()
        ig = self.integ

        def warm():
            ig._trip(st, Bk)
            st["it"].add_(1)

        with st["gates"].collect():
            graph, _, launches = self._capture_fn(
                pool, lambda: ig._stage_loop(st, Bk, thresh), warm,
                ig.record)
        return graph, launches


class DiffGraphs(_Captures):
    """One DiffRenderer's value_and_grad as the replay of a CUDA graph.

    The JAX package compiles `jit(value_and_grad(render_loss))` into one
    program that takes the parameters as its arguments.  Here the replay
    (`DiffRenderer.radiance`: all `n_steps` bounces, since under capture
    the host reads nothing), the loss and `torch.autograd.grad`'s
    backward are captured together into one `torch.cuda.CUDAGraph`; a
    call copies the lanes and the parameter values into the graph's
    fixed buffers (its leaves), replays it, and clones the loss and the
    gradients out of its static outputs (a later replay overwrites
    them).

    * Keys.  A graph is keyed by the lanes B, n_steps, sel_mode,
      edge_aware, the weight's shape (or no weight), the float type and
      the share's total rows (ShardedDiffRenderer); all share one memory
      pool, which holds every tensor the backward saves.
    * Capture.  A key's first call runs the eager call once on a side
      stream with host reads off (torch's warm-up recipe: it fills
      `Tracer._const`, the member stacks and autograd's lazy state),
      then captures, then replays.  A capture that fails raises: there
      is no eager fallback.
    * Lifetime.  Under `diff` the parameters reach the replay only
      through the leaves, so a graph serves every parameter value: those
      passed to value_and_grad and those set by set_geom/set_mat.  It
      keeps the device tables and constants its capture read (`_held`),
      which set_geom/set_mat would otherwise free.  Every graph is
      dropped when what the replay reads besides the leaves changes
      (`_statics`) or when `use_kernels` does (the route of the edge
      terms' detached queries).
    * Gates.  Each bounce's NEE and its backward run under IF nodes on
      the bounce's `any(di_gate)` (`cond.cond_grad`), as `lax.cond` and
      its VJP run in the JAX package's program.
    * Launch accounting as in DrainGraphs: the edge-aware terms' detached
      light hits may launch K3 inside the gated NEE, whose runs a call
      reads back with one read.
    """

    def __init__(self, owner):
        self._gen = self._digest = None
        super().__init__(owner)

    @property
    def dr(self):
        return self._owner()

    def _drop(self):
        self._pool = None
        self._graphs = {}     # key -> SimpleNamespace of one graph
        self._reset_costs()

    def _routing(self):
        dr = self.dr
        gen = (dr.tr._generation, dr.integ._generation, dr.edge_aware)
        if gen != self._gen:
            self._gen, self._digest = gen, _statics(dr)
        return dr.tr.use_kernels, self._digest

    def value_and_grad(self, q, params, weight=None, total=None):
        """(loss, grads) of DiffRenderer.share_value_and_grad for the
        lanes `q` (the device tensors of `_lanes`) at the parameter
        values `params` (device tensors, every key of params())."""
        dr = self.dr
        tok = self._routing()
        if tok != self._token:
            self._drop()
            self._token = tok
        if weight is not None:
            weight = torch.as_tensor(weight, dtype=dr.integ.tdtype,
                                     device=dr.integ.device)
        key = (q["p"].shape[0], dr.n_steps, dr.sel_mode, dr.edge_aware,
               None if weight is None else tuple(weight.shape),
               dr.integ.tdtype, total)
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = self._capture(q, params, weight,
                                                    total)
        with torch.no_grad():
            for k, buf in got.lanes.items():
                buf.copy_(q[k])
            for g, grp in got.leaves.items():
                for k, buf in grp.items():
                    buf.copy_(params[g][k])
            if weight is not None:
                got.weight.copy_(weight)
        spans.replay(dr.integ.record, got.graph, key[0])
        self.replays += 1
        for k, n in got.launches.items():
            kernels.LAUNCHES[k] += n
        if got.gates.launches:
            # launches in gated NEE bodies (the edge terms' K3): one read
            got.gates.settle(got.gates.runs.cpu().numpy())
        dr.steps_run = dr.n_steps
        return got.loss.clone(), {g: {k: v.clone() for k, v in grp.items()}
                                  for g, grp in got.grads.items()}

    def _capture(self, q, params, weight, total):
        """A graph of `_share` on fixed buffers holding q, params and
        weight: its lanes, leaves (requires_grad) and weight are the
        inputs a call copies into, its loss and grads the static
        outputs."""
        dr = self.dr
        got = SimpleNamespace(
            lanes={k: q[k].clone() for k in _LANE_FIELDS + ("is_path",)},
            leaves={g: {k: v.detach().clone().requires_grad_(True)
                        for k, v in grp.items()}
                    for g, grp in params.items()},
            weight=None if weight is None else weight.clone())
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        got.gates = cond.Gates(dr.integ.device)
        with got.gates.collect():
            got.graph, (got.loss, got.grads), got.launches = \
                self._capture_fn(self._pool, lambda: dr._share(
                    got.leaves, got.lanes, got.weight, total),
                    rec=dr.integ.record)
        got.held = _held(dr)
        return got


def _statics(dr):
    """A digest of what the replay reads besides its leaves and the
    scene's structure, which set_geom may change: the standalone SDF
    objects' frames and parameters (`Tracer.sdf_singles`: the march runs
    on them, and reattaches its hits through the leaves), and with
    edge_aware the tracer's own leaf table (the silhouette terms' light
    and composite queries run detached, without the overrides).  No
    material table is read but through the leaves."""
    tr = dr.tr
    h = hashlib.blake2b(digest_size=16)
    for lf, *_ in tr.sdf_singles:
        for a in (lf.m, lf.m0, lf.sdf_param):
            h.update(np.asarray(a, np.float64).tobytes())
    if dr.edge_aware:
        for a in tr.tables_np:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _held(dr):
    """The device tensors a captured replay may read outside its own
    buffers and pool (the tables, the cached constants and indices):
    a graph keeps them, since set_geom and set_mat replace them."""
    tr, ig = dr.tr, dr.integ
    return (dict(tr._kernel_cache), dict(tr._idx_cache), tr.tabs,
            tr.t_env_c, tr.t_env_r, tr.t_neg, tr.t_oid, tr.t_rough,
            dict(ig._dev), ig._P, dict(ig._kernel_cache))
