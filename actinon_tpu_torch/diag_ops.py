"""Elementwise diagnostic kernels (K8, K9) beside torch's own ops.

    python -m actinon_tpu_torch.diag_ops [--device cuda|cpu]

Counterpart of the JAX package's `tools/diag_tpu_ops.py`, which ran sin,
cos, sqrt, rsqrt, exp (`pallas_unary`), a / b and a * b + c (the inline
kernel of its `main`) inside Pallas kernels and against XLA's own
lowering, to measure where a hand-written kernel's arithmetic departs from
the framework's.  Here the same ops run in one hand-written CUDA kernel
(`csrc/diag_ops.cu`, an op code per launch) against torch's ops on the
same tensors, and the einsum check compares `torch.einsum` and the
explicit sum with f64 numpy (TF32 off, as the package sets it).

  * `unary` (K8) — replaces `tools/diag_tpu_ops.py` `pallas_unary`;
  * `expr`  (K9) — replaces the inline kernel of `tools/diag_tpu_ops.py`
    `main`.

Triton would serve a pass this simple as well; CUDA C++ keeps one build
(the one `nvcc` call of `render/kernels.py`) and one loader.  A wrapper
takes the plain version, torch's own op, when its tensors lie on the CPU,
and only then; on a CUDA tensor it launches the kernel or raises, and each
launch adds one to `kernels.LAUNCHES` ("diag_unary", "diag_expr").
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from actinon_tpu_torch.config import resolve_device
from actinon_tpu_torch.render import kernels

SHAPE = (32, 128)     # the tool's tile
# op codes: must match csrc/diag_ops.cu
UNARY = {"sin": 0, "cos": 1, "sqrt": 2, "rsqrt": 3, "exp": 4}
EXPR = {"div": 5, "mul_add": 6}
# the input ranges of the JAX tool
RANGES = {"sin": (0, 2 * np.pi), "cos": (0, 2 * np.pi),
          "sqrt": (1e-6, 100), "rsqrt": (1e-6, 100), "exp": (-10, 3)}
LABELS = {"sin": "sin[0,2pi]", "cos": "cos[0,2pi]", "sqrt": "sqrt(0,100]",
          "rsqrt": "rsqrt(0,100]", "exp": "exp[-10,3]"}


def unary_plain(name, x):
    return getattr(torch, name)(x)


def expr_plain(name, a, b, c=None):
    return a / b if name == "div" else a * b + c


def _launch(key, op, out, a, b, c):
    n = a.numel()
    for t, nm in ((a, "a"), (b, "b"), (c, "c")):
        kernels._check(t, a.shape, torch.float32, nm)
    if n:
        rc = kernels._lib().actinon_diag_op(
            op, a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), n,
            kernels._stream())
        kernels._launched(key, rc)
    return out


def unary(name, x):
    """K8: sin, cos, sqrt, rsqrt or exp of every element of x (f32)."""
    if x.device.type == "cpu":
        return unary_plain(name, x)
    return _launch("diag_unary", UNARY[name], torch.empty_like(x), x, x, x)


def expr(name, a, b, c=None):
    """K9: a / b ("div") or a * b + c ("mul_add"), elementwise (f32)."""
    if a.device.type == "cpu":
        return expr_plain(name, a, b, c)
    return _launch("diag_expr", EXPR[name], torch.empty_like(a), a, b,
                   b if c is None else c)


def ulp_diff(a, b):
    """|a - b| in units in the last place of f32 (the bit patterns'
    distance, as the JAX tool measures it)."""
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return torch.abs(ai - bi)


def tool_inputs(device, seed=0):
    """The JAX tool's inputs, drawn in its order from one numpy generator:
    the five unary inputs, then a, b, c of the expressions, then the
    einsum's frames [1024, 3, 3] and directions [1024, 8, 3]."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=device)
    xs = {k: t(rng.uniform(*RANGES[k], SHAPE).astype(np.float32))
          for k in UNARY}
    a = rng.uniform(-2, 2, SHAPE).astype(np.float32)
    b = rng.uniform(0.1, 2, SHAPE).astype(np.float32)
    c = rng.uniform(-2, 2, SHAPE).astype(np.float32)
    fr = rng.normal(0, 1, (1024, 3, 3)).astype(np.float32)
    lo = rng.normal(0, 1, (1024, 8, 3)).astype(np.float32)
    return dict(x=xs, args={"div": (t(a), t(b)), "mul_add": (t(a), t(b),
                                                             t(c))},
                frames=fr, dirs=lo)


def compare(device="cuda", seed=0):
    """Each op of the kernel against torch's on the tool's inputs: rows of
    (name, kind, bit_equal share, max ulp, mean ulp, max |difference|)."""
    dev = resolve_device(device)
    inp = tool_inputs(dev, seed)
    rows = []
    for name in UNARY:
        x = inp["x"][name]
        rows.append(_row(name, "unary", unary(name, x), unary_plain(name, x)))
    for name in EXPR:
        args = inp["args"][name]
        rows.append(_row(name, "expr", expr(name, *args),
                         expr_plain(name, *args)))
    return rows


def _row(name, kind, got, want):
    ud = ulp_diff(got, want)
    return dict(name=name, kind=kind,
                bit_equal=float((ud == 0).double().mean()),
                max_ulp=int(ud.max()), mean_ulp=float(ud.double().mean()),
                max_abs_err=float(torch.abs(got - want).max()))


def einsum_check(device="cuda", seed=0):
    """[B,3,3] frames @ [B,S,3] directions: torch.einsum and the explicit
    elementwise sum, each against f64 numpy; max and mean relative
    error."""
    dev = resolve_device(device)
    inp = tool_inputs(dev, seed)
    fr, lo = inp["frames"], inp["dirs"]
    want = np.einsum("bij,bsj->bsi", fr.astype(np.float64),
                     lo.astype(np.float64))
    f, l = torch.as_tensor(fr, device=dev), torch.as_tensor(lo, device=dev)
    ein = torch.einsum("bij,bsj->bsi", f, l)
    explicit = torch.stack(
        [sum(f[:, None, i, j] * l[:, :, j] for j in range(3))
         for i in range(3)], dim=-1)
    out = {}
    for name, got in (("einsum_default", ein), ("explicit", explicit)):
        rel = np.abs(got.cpu().numpy() - want) / (np.abs(want) + 1e-6)
        out[name] = dict(max_rel=float(rel.max()), mean_rel=float(rel.mean()))
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    dev = resolve_device(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu")
    for r in compare(dev):
        label = LABELS.get(r["name"], r["name"])
        tail = f" mean_ulp={r['mean_ulp']:.3f}" if r["kind"] == "unary" \
            else ""
        print(f"{label:14s} bit-equal={r['bit_equal']:.4f} "
              f"max_ulp={r['max_ulp']}{tail}")
    for name, r in einsum_check(dev).items():
        print(f"{name:14s} max_rel={r['max_rel']:.3e} "
              f"mean_rel={r['mean_rel']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
