"""One run of one cell: set-up, the measured window, the reading of the
per-layer metrics (traced run only), and the comparison with the plain
reference that decides `correct`.  Everything that belongs to one
configuration, traffic mix, metric or cell is found by name under
`portbench/` of the checkout: the configuration's file and its plain
reference, `traffic/<traffic>.json` and the kind it names,
`metrics/<metric>.py` and `limits/<workload>.json`."""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "actinon_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve(root, workload, bench=None):
    """(bench, cell, config, traffic, limits) of a workload by name."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    home = os.path.join(root, "portbench")
    traffic = load_json(os.path.join(home, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(home, "limits", workload + ".json"))
    return bench, cell, config, traffic, limits


def cell_metrics(bench, workload, trace):
    """The metrics a run of the cell reports: its end-to-end metrics
    (trace 0) or its per-layer metrics (trace 1): those that list the
    cell, or list no cell and move an end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in moved]


def load(path, name):
    """The module of the file at path, loaded under name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root, name):
    """The reader of a metric: `portbench/metrics/<name>.py`'s
    read(rec)."""
    return load(os.path.join(root, "portbench", "metrics", name + ".py"),
                "portbench_metric_" + name.replace(".", "_")).read


REFERENCE = "portbench/reference.py"


def reference(root, config):
    """The configuration's plain reference: the module at its key
    "reference", a path from the root of the checkout, or
    `portbench/reference.py` without one (what it provides: kinds.py)."""
    path = config.get("reference", REFERENCE)
    name = os.path.splitext(os.path.basename(path))[0]
    return load(os.path.join(root, path), "portbench_reference_" + name)


def cell_kind(root, config, traffic, seed, device):
    """The traffic kind that the mix names, made for one run: the class
    in `kinds.KINDS`, else `portbench/traffic/<kind>.py`'s KIND; it
    judges with the configuration's reference."""
    import kinds
    name = traffic["kind"]
    cls = kinds.KINDS.get(name) or load(
        os.path.join(root, "portbench", "traffic", name + ".py"),
        "portbench_kind_" + name).KIND
    return cls(config, traffic, seed, root, device, reference(root, config))


REPLAY = "portbench.replay"


@contextlib.contextmanager
def profiler_outside_graphs(prof):
    """The profiler's device collection off while a CUDA graph is
    captured or replayed (it misses kernels in conditional nodes, and a
    traced replay of them can fault the card); each replay is marked on
    the host timeline as REPLAY instead."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    graph, cuda = torch.cuda.CUDAGraph, [ProfilerActivity.CUDA]
    orig = {n: getattr(graph, n)
            for n in ("replay", "capture_begin", "capture_end")}

    def replay(g):
        prof.toggle_collection_dynamic(False, cuda)
        try:
            with record_function(REPLAY):
                orig["replay"](g)
        finally:
            prof.toggle_collection_dynamic(True, cuda)

    def capture_begin(g, *a, **kw):
        prof.toggle_collection_dynamic(False, cuda)
        return orig["capture_begin"](g, *a, **kw)

    def capture_end(g, *a, **kw):
        try:
            return orig["capture_end"](g, *a, **kw)
        finally:
            prof.toggle_collection_dynamic(True, cuda)

    graph.replay, graph.capture_begin, graph.capture_end = \
        replay, capture_begin, capture_end
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(graph, n, fn)


def _each_s(spans):
    """Each replay's device seconds (replay_spans' pairs), in order."""
    import torch
    torch.cuda.synchronize()
    return [a.elapsed_time(b) / 1e3 for a, b in spans]


def forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(root, workload, seed, seconds, trace, t_start, device="cuda",
             bench=None):
    """One run; returns (result dict, check lines)."""
    import torch
    bench, cell, config, traffic, limits = resolve(root, workload, bench)
    cuda = torch.device(device).type == "cuda"
    tmpdir = tempfile.gettempdir()
    kind = cell_kind(root, config, traffic, seed, device)
    kind.setup(tmpdir)
    if cuda:
        torch.cuda.synchronize()
    rec = dict(cell=kind, workload=workload, device=device, units=[],
               setup_s=time.perf_counter() - t_start,
               scene_load_s=kind.scene_load_s)

    with contextlib.ExitStack() as stack:
        spans = prof = None
        if trace:
            import timing
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            spans = stack.enter_context(timing.replay_spans())
            if cuda:
                stack.enter_context(profiler_outside_graphs(prof))
        t0 = time.perf_counter()
        k = 0
        while True:
            n0 = len(spans) if trace else 0
            u = kind.run_unit(k)
            u["spans"] = (n0, len(spans)) if trace else None
            rec["units"].append(u)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        rec["window_s"] = time.perf_counter() - t0
    if trace and cuda:
        import devtrace
        each = _each_s(spans)
        for u in rec["units"]:
            u["replay_s"] = sum(each[slice(*u["spans"])])
        rec["busy_s"], ops, gaps = devtrace.summarise(
            devtrace.read_trace(prof, tmpdir), each)
        rec["breakdown"] = {"device_ops": ops, "idle_gaps": gaps}
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = reader(root, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    unit_s = [u["wall_s"] for u in rec["units"]]
    busy = {k: rec[k] for k in ("busy_s", "window_s")} \
        if trace and cuda else {}
    breakdown = rec.get("breakdown")
    rec.clear()
    kind.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    per_unit = kind.judge(device)
    judge_s = time.perf_counter() - t0
    kind.close()
    worst = {}
    for got in per_unit:
        for n, v in got.items():
            worst[n] = v if n not in worst or not v <= worst[n] \
                else worst[n]
    checks = {n: {"value": worst.get(n, float("inf")), "limit": lim}
              for n, lim in limits.items()}
    failed = sum(not all(got.get(n, float("inf")) <= lim
                         for n, lim in limits.items()) for got in per_unit)
    result = {"correct": bool(per_unit) and failed == 0,
              "attempted": len(kind.kept), "failed": failed,
              "metrics": metrics, "unit_s": unit_s}
    if cuda:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": cell["chips"],
                            "memory_peak_bytes": int(peak), **busy}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"reference seconds: {judge_s!r}"] + [
        f"check {n}: {c['value']!r} (limit {c['limit']!r})"
        for n, c in checks.items()]
    return result, lines
