"""What the profiler's trace of the traced window says: the device time
of the kernels, copies and fills outside any CUDA-graph replay (the
profiler's device collection is off in every replay and capture:
harness.profiler_outside_graphs), and the window's longest idle gaps by
what the host was doing."""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def read_trace(prof, tmpdir):
    """The profiler's events as a list of chrome-trace dicts; the file it
    writes into tmpdir is removed again."""
    path = os.path.join(tmpdir, f"portbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _host_at(host, starts, t, scan=5000):
    """The innermost host op running at t: the latest to start of those
    that hold t."""
    i = bisect.bisect_right(starts, t)
    for h in reversed(host[max(0, i - scan):i]):
        if h[1] >= t:
            return h[2]
    return "host outside any op"


def summarise(events, replays, replay_name="CUDAGraph.replay"):
    """(busy seconds, device_ops, idle_gaps) of a trace taken with the
    device collection off in every replay; replays: each replay's
    CUDA-event seconds, in order.  Busy: the replays' seconds plus the
    union of the device intervals the trace holds.  device_ops: the ten
    largest device totals by name, the replays as one entry.  idle_gaps:
    the gaps of 1 ms or more between device intervals, each replay placed
    at its host mark (harness.REPLAY) for its seconds, summed by the host
    op running at each gap's middle, the ten largest."""
    from harness import REPLAY
    outside = []
    by_name = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            outside.append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6))
            by_name[e["name"]] += e["dur"] * 1e-6
    by_name[replay_name] += sum(replays)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    marks = sorted(e["ts"] * 1e-6 for e in events
                   if e.get("name") == REPLAY and "dur" in e)
    every = outside + [(t, t + s) for t, s in zip(marks, replays)]
    host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                  for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e
                  and e.get("name") != REPLAY)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    end = None
    for a, b in sorted(every):
        if end is not None and a - end >= 1e-3:
            gaps[_host_at(host, starts, (a + end) / 2)] += a - end
        end = b if end is None else max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return sum(replays) + _union(outside), [list(o) for o in ops], \
        [list(g) for g in idle]
