"""The device drain's trips as replays of CUDA graphs.

The JAX package runs its whole device drain as one jitted
`lax.while_loop` (its `run_device`), so a pass costs the host nothing per
trip.  Here a trip is `Integrator._trip`, a few hundred torch ops and
hand-written kernel launches that read nothing back to the host.
`DrainGraphs` captures one trip per stage into a `torch.cuda.CUDAGraph`
and replays it: the host issues one graph launch a trip and reads one
count (`Integrator._drain`, which picks the next stage from it), and the
trips, their sizes and their order are those of the eager drain.

* Keys and buffers.  A drain's state (`Integrator._drain_state`: the
  queue, the accumulator, the count, dropped and queries) is made once
  per queue shape (capacity C, rows) and kept, so that a graph's
  addresses hold; its accumulator has a row for every sample id the
  capacity admits, so passes with other sample counts share it.  A graph
  is keyed by that shape and the stage Bk; the graphs of one shape share
  one memory pool.
* Capture.  A key's first trip runs eagerly on a side stream (torch's
  warm-up recipe; it is a real trip of the drain, and it loads every
  kernel and fills every cache the trip reads), then the trip is captured
  (which runs nothing).  A capture that fails raises: there is no eager
  fallback.
* Lifetime.  Graphs are reused across drains and passes, and dropped with
  their state when the tracer's or the integrator's tables change
  (`Tracer.set_geom`, `Integrator.set_mat`: their `_generation`) or when
  a setting that routes the trip does (seed mode, kernels on or off).
* Launch accounting.  `kernels.LAUNCHES` counts in the wrappers, which
  run only at capture; each graph keeps the launches its capture counted,
  and every replay adds them, so `LAUNCHES` counts what the card ran.
"""

from __future__ import annotations

import time

import torch

from actinon_tpu_torch.render import kernels


class DrainGraphs:
    """The captured trips of one integrator's device drain."""

    def __init__(self, integ):
        self.integ = integ
        self._token = None
        self._drop()

    def _drop(self):
        self._states = {}     # (C, rows) -> drain state
        self._pools = {}      # (C, rows) -> graph memory pool
        self._graphs = {}     # (C, rows, Bk) -> (graph, launches)
        # what the captures cost: how many, their seconds, and the device
        # memory the caching allocator reserved during them
        self.captures = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

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

    def trip(self, st, Bk):
        """One trip of stage Bk on the state `st`: the replay of its graph,
        or at the key's first trip the warm-up trip and the capture."""
        key = st["key"] + (Bk,)
        got = self._graphs.get(key)
        if got is None:
            self._graphs[key] = self._capture(st, Bk)
            return
        graph, launches = got
        graph.replay()
        for k, n in launches.items():
            kernels.LAUNCHES[k] += n

    def _capture(self, st, Bk):
        ig = self.integ
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ig._trip(st, Bk)          # the warm-up: this trip, for real
        torch.cuda.current_stream().wait_stream(side)
        before = dict(kernels.LAUNCHES)
        pool = self._pools.get(st["key"])
        if pool is None:
            pool = self._pools[st["key"]] = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            # (read here: entering the capture empties the allocator's
            # cache)
            reserved = torch.cuda.memory_reserved()
            ig._trip(st, Bk)
        torch.cuda.synchronize()
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        self.captures += 1
        # the capture ran nothing: its counts move to the replays
        launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                    if n != before[k]}
        kernels.LAUNCHES.update(before)
        return graph, launches
