"""Device-side control flow in the captured paths: the port's counterpart
of the JAX package's `lax.cond` and `lax.while_loop`.

The JAX package decides on the device wherever its jitted programs branch
or loop on data: the NEE runs under `lax.cond(any(di_gate), ...)`, and
its VJP through the same cond (actinon_tpu/render/integrator.py:515-526);
the SDF march is a `lax.while_loop` while a lane is active
(tracer.py:871-882); `run_device`'s drain is a cascade of
`lax.while_loop`s, stage k running while the count exceeds the next
stage's batch (integrator.py:1617-1747).  Here `if_node`, `while_loop`
and `cond_grad` make those decisions, in one of four ways:

* Under a CUDA-graph capture (entered with `capture`) each records a
  conditional node of the graph, an IF or a WHILE node
  (csrc/graph_cond.cu): at every replay the card tests the predicate, a
  0-d bool device tensor, and runs the body or skips it, with no host
  read.
* Where the host may read the device (`tracer.host_reads_ok`) they read
  the predicate and decide on the host: the eager paths.
* On the `meta` device, which holds no data (the CPU tests' capture
  detectors), `if_node` runs its body and `while_loop` one pass of it.
* In a capture's warm-up (`tracer.no_host_reads` off a capture)
  `if_node` runs its body without a read: each caller's body adds
  nothing when its predicate is false (the NEE where no lane shades
  diffusely, march steps once no lane is active).  `while_loop` has no
  warm-up: its caller warms up one pass that it knows runs.

A `with` block cannot skip itself, so `if_node` yields whether to run the
body and the body tests it: `with if_node(p) as run: if run: ...`.

* Memory.  A body is captured on a stream of its own (one for each
  nesting depth), whose allocations the caching allocator would not
  route to the graph's pool; within `capture` every allocation goes to
  the graph's pool, the bodies' too.
* Launch accounting.  `kernels.LAUNCHES` counts a launch when its wrapper
  runs: under a capture, once, at capture time.  A body's launches run
  as often as the body does, which only the card knows, so the launches
  counted while a body was captured (or warmed up) are taken back out of
  LAUNCHES, and the body adds one to a device counter of a `Gates` each
  time it runs (a warm-up adds its predicate); the owner of the graph
  reads the counters back with its own read (`Gates.settle`).
* No fallback.  `capture` checks once, at the first capture, that the
  driver, the runtime and torch offer what this needs (`require`: a
  small graph of an IF and a WHILE node replayed both ways), and raises
  if they do not; nothing replays a flattened graph instead.
"""

from __future__ import annotations

import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from actinon_tpu_torch.render import kernels

_IF, _WHILE = 0, 1
CUDA_MIN = 12040        # conditional nodes with nested bodies: CUDA 12.4

_S = SimpleNamespace(pool=None, depth=0, streams=[], gates=[], lib=None,
                     ok=None, why=None)


def _reads_ok(device) -> bool:
    # tracer imports this module; its host_reads_ok is the one rule
    from actinon_tpu_torch.render import tracer
    return tracer.host_reads_ok(device)


def _lib():
    if _S.lib is None:
        _S.lib = bind(kernels._lib())
    return _S.lib


def bind(lib):
    """Declare the conditional-node functions of a loaded kernel library
    (csrc/graph_cond.cu) to ctypes; returns it."""
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.actinon_cond_begin.argtypes = [I, P, P, P, ctypes.POINTER(U)]
    lib.actinon_cond_set.argtypes = [P, U, P]
    lib.actinon_cond_end.argtypes = [P]
    lib.actinon_cond_versions.argtypes = [ctypes.POINTER(I)] * 2
    for fn in (lib.actinon_cond_begin, lib.actinon_cond_set,
               lib.actinon_cond_end, lib.actinon_cond_versions):
        fn.restype = I
    return lib


def _ok(rc, what):
    if rc != 0:
        raise RuntimeError(f"conditional node: {what} failed: CUDA error "
                           f"{rc}")


def versions():
    """(driver, runtime): the CUDA versions, 1000 major + 10 minor."""
    drv, rt = ctypes.c_int(), ctypes.c_int()
    _ok(_lib().actinon_cond_versions(ctypes.byref(drv), ctypes.byref(rt)),
        "cudaDriverGetVersion")
    return drv.value, rt.value


def _probe():
    """None when conditional nodes work here, else why they do not."""
    for name in ("_cuda_beginAllocateToPool", "_cuda_endAllocateToPool",
                 "_cuda_releasePool"):
        if not hasattr(torch._C, name):
            return f"torch {torch.__version__} lacks torch._C.{name}"
    drv, rt = versions()
    if min(drv, rt) < CUDA_MIN:
        return (f"CUDA driver {drv} / runtime {rt}: conditional nodes "
                f"need {CUDA_MIN}")
    x = torch.zeros(3, dtype=torch.int64, device="cuda")
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
    _S.ok = True          # this capture is the check
    try:
        with capture(graph, pool):
            with if_node(flag) as run:
                if run:
                    x[0].add_(1)
            while_loop(lambda: x[1] < 4, lambda: x[1].add_(1))
            x[2].add_(1)
        graph.replay()
        flag.fill_(True)
        graph.replay()
        got = x.tolist()
    except RuntimeError as e:
        return f"a graph with conditional nodes failed: {e}"
    finally:
        _S.ok = None
    if got != [1, 4, 2]:
        return f"a graph with conditional nodes gave {got}, not [1, 4, 2]"
    return None


def require():
    """Raise unless CUDA-graph conditional nodes work on this card, torch
    and driver (checked once)."""
    if _S.ok is None:
        while len(_S.streams) < 4:        # the bodies' streams
            _S.streams.append(torch.cuda.Stream())
        why = _probe()
        _S.ok = why is None
        _S.why = why
    if not _S.ok:
        raise RuntimeError("CUDA-graph conditional nodes are unavailable: "
                           f"{_S.why}; the captured paths need them (set "
                           "drain_graphs / diff_graphs = False to run "
                           "eagerly)")


@contextlib.contextmanager
def capture(graph, pool):
    """`torch.cuda.graph(graph, pool=pool)`, the capture that if_node,
    while_loop and cond_grad record their nodes into.  Every allocation
    made within it, on any stream and thread, goes to the graph's pool
    (torch routes only its capture stream's), so the bodies' memory lives
    with the graph.  torch's capture_end ends the routing, but raises
    before it when the capture failed, which would leave every later
    allocation going to this pool: then it is ended here.  `require()`
    comes first."""
    if not _S.ok:
        raise RuntimeError("cond.require() comes before the capture")
    dev = torch.cuda.current_device()
    try:
        with torch.cuda.graph(graph, pool=pool):
            torch._C._cuda_endAllocateToPool(dev, pool)
            torch._C._cuda_beginAllocateToPool(dev, pool)
            torch._C._cuda_releasePool(dev, pool)   # begin counted a use
            _S.pool = pool
            try:
                yield
            finally:
                _S.pool = None
    except BaseException:
        try:
            torch._C._cuda_endAllocateToPool(dev, pool)
        except RuntimeError:       # capture_end had ended it
            pass
        raise


def _capturing(device) -> bool:
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return False
    if _S.pool is None:
        raise RuntimeError("a conditional node needs its capture entered "
                           "with cond.capture")
    return True


@contextlib.contextmanager
def _body(kind, pred):
    """Append a conditional node on `pred` to the capture and capture the
    body into it, on the stream of the nesting depth; yields the node's
    handle.  Within the body torch's sync debug mode is "error": a host
    read there raises before it reaches the card, since a capture that
    CUDA invalidates inside a conditional body leaves the driver unable
    to end or destroy the graph (the process faults)."""
    lib = _lib()
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise TypeError("a predicate is a 0-d bool tensor")
    d = _S.depth
    while len(_S.streams) <= d:
        _S.streams.append(torch.cuda.Stream())
    body = _S.streams[d]
    handle = ctypes.c_ulonglong()
    _ok(lib.actinon_cond_begin(kind, torch.cuda.current_stream().cuda_stream,
                               body.cuda_stream, pred.data_ptr(),
                               ctypes.byref(handle)), "begin")
    sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    _S.depth += 1
    try:
        with torch.cuda.stream(body):
            yield handle.value
    finally:
        _S.depth -= 1
        torch.cuda.set_sync_debug_mode(sync_mode)
        _ok(lib.actinon_cond_end(body.cuda_stream), "end")


class Gates:
    """Device counters of the runs of gated bodies, for launch accounting:
    entry i counts the runs of the bodies one run of which launches
    `launches[i]` ({kernel: launches}).  Bodies record into the innermost
    `collect()`."""

    SIZE = 32

    def __init__(self, device):
        self.runs = torch.zeros(self.SIZE, dtype=torch.int64, device=device)
        self.launches = []
        self._added = np.zeros(self.SIZE, np.int64)

    @contextlib.contextmanager
    def collect(self):
        _S.gates.append(self)
        try:
            yield self
        finally:
            _S.gates.pop()

    def _entry(self, launches):
        if launches not in self.launches:
            if len(self.launches) == self.SIZE:
                raise RuntimeError("Gates: more than SIZE kinds of body")
            self.launches.append(launches)
        return self.launches.index(launches)

    def settle(self, runs):
        """Add to LAUNCHES the launches of the runs counted since the last
        settle; `runs` is `self.runs` read to the host by the caller."""
        runs = np.asarray(runs, np.int64)
        new = runs - self._added
        for i, launches in enumerate(self.launches):
            for k, n in launches.items():
                kernels.LAUNCHES[k] += int(new[i]) * n
        self._added = runs.copy()


def _gated(before, pred=None):
    """The launches counted since `before` belong to a gated body: take
    them out of LAUNCHES and count the body's run on the device, one a
    pass in a captured body, `pred` in a warm-up."""
    got = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
           if n != before[k]}
    if not got:
        return
    kernels.LAUNCHES.update(before)
    if not _S.gates:
        raise RuntimeError("a gated body launched kernels outside "
                           "Gates.collect()")
    gates = _S.gates[-1]
    cell = gates.runs[gates._entry(got)]
    cell.add_(1 if pred is None else pred.to(torch.int64))


@contextlib.contextmanager
def if_node(pred):
    """`lax.cond(pred, body, skip)` for a body that updates device state in
    place: yields whether to run the body (module docstring)."""
    dev = pred.device
    if dev.type == "meta":
        yield True
    elif _capturing(dev):
        before = dict(kernels.LAUNCHES)
        with _body(_IF, pred):
            yield True
            _gated(before)
    elif _reads_ok(dev):
        yield bool(pred)
    else:
        before = dict(kernels.LAUNCHES)
        yield True
        _gated(before, pred)


def while_loop(cond_fn, body_fn, bound=None):
    """`lax.while_loop(cond, body)` over device state that `body_fn()`
    updates in place; `cond_fn()` gives the 0-d bool predicate.  `bound`:
    the most passes the loop makes, where a pass after the predicate
    turned false changes nothing; a warm-up then runs that many passes
    without a read (without it, a warm-up raises)."""
    pred = cond_fn()
    dev = pred.device
    if dev.type == "meta":
        body_fn()
        cond_fn()
    elif _capturing(dev):
        before = dict(kernels.LAUNCHES)
        with _body(_WHILE, pred) as handle:
            body_fn()
            _gated(before)
            nxt = cond_fn()
            _ok(_lib().actinon_cond_set(
                torch.cuda.current_stream().cuda_stream, handle,
                nxt.data_ptr()), "set")
    elif _reads_ok(dev):
        while bool(pred):
            body_fn()
            pred = cond_fn()
    elif bound is not None:
        for _ in range(bound):
            body_fn()
    else:
        raise RuntimeError("while_loop runs under a capture or with host "
                           "reads: a warm-up runs one pass itself")


class _Cond(torch.autograd.Function):
    """cond_grad's autograd node.  forward runs `fn` under an IF node on
    inputs detached from the outer graph, with grad on, keeps its inner
    graph and returns its output (zeros where skipped); backward runs
    `torch.autograd.grad` over that inner graph under an IF node on the
    same predicate, into buffers zeroed before the node, so the backward
    of a skipped body never runs on the stale tensors it saved, as
    `lax.cond`'s VJP takes only the branch that ran."""

    @staticmethod
    def forward(ctx, pred, fn, like, *xs):
        need = ctx.needs_input_grad[3:]
        inner = [x.detach().requires_grad_() if n else x
                 for x, n in zip(xs, need)]
        out = torch.zeros_like(like)
        y = None
        with if_node(pred) as run:
            if run:
                with torch.enable_grad():
                    y = fn(*inner)
                out.copy_(y.detach())
        ctx.pred, ctx.y = pred, y
        ctx.xs = [x for x, n in zip(inner, need) if n]
        ctx.need = need
        return out

    @staticmethod
    def backward(ctx, g):
        xs, y = ctx.xs, ctx.y
        ctx.xs = ctx.y = None
        # one zeroed buffer per float type, the gradients views into it
        grads = [None] * len(xs)
        by_type = {}
        for i, x in enumerate(xs):
            by_type.setdefault(x.dtype, []).append(i)
        for dt, idx in by_type.items():
            flat = torch.zeros(sum(xs[i].numel() for i in idx), dtype=dt,
                               device=g.device)
            at = 0
            for i in idx:
                n = xs[i].numel()
                grads[i] = flat[at:at + n].view(xs[i].shape)
                at += n
        if y is not None and xs:
            with if_node(ctx.pred) as run:
                if run:
                    got = torch.autograd.grad(y, xs, g, allow_unused=True)
                    for buf, v in zip(grads, got):
                        if v is not None:
                            buf.copy_(v)
        it = iter(grads)
        return (None, None, None) + tuple(next(it) if n else None
                                          for n in ctx.need)


def cond_grad(pred, fn, like, *xs):
    """`lax.cond(pred, fn, zeros)` under autograd: fn(*xs), a tensor shaped
    like `like`, where `pred` holds and zeros elsewhere, with its backward
    gated by the same predicate.  `xs` holds every tensor with a gradient
    that fn reads (other arguments pass through)."""
    return _Cond.apply(pred, fn, like, *xs)
