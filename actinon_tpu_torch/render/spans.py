"""Spans and counters of one render call, on the profiler's clock.

A `Record` hangs on an `Integrator` (`integ.record`, None by default);
`driver.render_scene` makes one when its caller passes `stats` and puts
what it holds there.  The layers write into it at their boundaries:

* spans: [name, start_s, end_s, parent_index], in seconds of
  `time.perf_counter()` from the record's start, each under the span
  open when it began (index 0, the driver's `driver.image`, has parent
  None).  While a torch profiler records, each span is also a
  `torch.profiler.record_function` range of the same name, so the
  profiler's trace puts host time (and the device's idle gaps) down to
  them; with no profiler on, no annotation is made.
* counters: counts by name (`driver.renderer_kept`, `drain.host_reads`,
  `graphs.captures`, `graphs.pool_bytes`).
* device_spans: [stage_batch, seconds] of each CUDA-graph replay, from a
  pair of CUDA events around it.  The events are resolved by `result()`,
  which the caller calls after a host read has synchronised with the
  replays (the drain's last read does): it adds no synchronisation.

A call made while a torch profiler records also leaves its `stats` in
`profiled` (`publish`), so that a reader of the profiled window finds
each call's record after the caller has dropped the dict.

Where the record is None every helper here is a shared no-op (`span`,
`count`) or the bare call (`replay`)."""

from __future__ import annotations

import collections
import contextlib
import time

import torch

_NOOP = contextlib.nullcontext()

# the stats of the render calls made while a torch profiler recorded,
# oldest first
profiled = collections.deque(maxlen=4096)


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class Span:
    """A timed interval: `t0` and `t1` are the perf_counter readings at
    its entry and exit.  With a record it is also the record's span (and
    a record_function range while a profiler records); without one it
    only times, for a caller that needs the seconds in any case."""

    __slots__ = ("rec", "name", "t0", "t1", "_i", "_ann")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self._ann = None
        if self.rec is not None and _profiling():
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        if self.rec is not None:
            self._i = self.rec._open(self.name, self.t0)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.rec is not None:
            self.rec._close(self._i, self.t1)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Record:
    """What one call's layers recorded (the module's docstring)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.spans = []
        self.counters = {}
        self._open_at = []       # indices of the spans open, innermost last
        self._events = []        # (stage_batch, start event, end event)

    def _open(self, name, t):
        parent = self._open_at[-1] if self._open_at else None
        self.spans.append([name, t - self.t0, None, parent])
        self._open_at.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def _close(self, i, t):
        self._open_at.pop()
        self.spans[i][2] = t - self.t0

    def replay(self, graph, batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        self._events.append((batch, a, b))

    def result(self) -> dict:
        """spans, counters and device_spans, the events resolved; call it
        once a host read has waited for the last replay."""
        return dict(spans=self.spans, counters=dict(self.counters),
                    device_spans=[[k, a.elapsed_time(b) / 1e3]
                                  for k, a, b in self._events])


def publish(stats):
    """Keep a call's `stats` in `profiled` while a profiler records."""
    if _profiling():
        profiled.append(stats)


def span(rec, name):
    """The record's span `name` (a context manager), or a shared no-op."""
    return _NOOP if rec is None else Span(rec, name)


def count(rec, name, n=1):
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def replay(rec, graph, batch):
    """graph.replay(), bracketed by the record's CUDA events (a device
    span of a stage of `batch` lanes) where there is a record."""
    if rec is None:
        graph.replay()
    else:
        rec.replay(graph, batch)
