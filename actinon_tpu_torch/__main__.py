"""CLI: `python -m actinon_tpu_torch <script.acn> [-f] [-r] [args...]`.

Mirrors the reference shell (reference src/main.c:76-122): `-f` overwrites
outputs without prompting, `-r` auto-recovers from checkpoints; remaining
arguments are forwarded to the script as `program_args`.  (Quirk parity:
like the reference, `-f` is also forwarded to the script,
reference src/main.c:100-105.)

Options of this port:
  --dtype f32|f64     compute dtype (default f32; CUDA runs f32 only)
  --batch N           wavefront batch size
  --device cuda|cpu   where to render (default cuda)
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 1

    script = None
    force = recover = False
    dtype = np.float32
    batch = 1 << 14
    device = "cuda"
    fwd = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--dtype":
            i += 1
            dtype = np.float64 if argv[i] in ("f64", "float64") \
                else np.float32
        elif a == "--batch":
            i += 1
            batch = int(argv[i])
        elif a == "--device":
            i += 1
            device = argv[i]
        else:
            if a == "-f":
                force = True
                fwd.append(a)   # quirk parity: -f is forwarded too
            elif a == "-r":
                recover = True
            elif script is None:
                script = a
            else:
                fwd.append(a)
        i += 1

    if script is None:
        print("usage: python -m actinon_tpu_torch <script.acn> [-f] [-r]")
        return 1

    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.driver import render_scene

    def render_fn(scene, fname):
        render_scene(scene, fname, force=force, recover=recover,
                     dtype=dtype, batch=batch, device=device)

    run_file(script, render_fn=render_fn, args=fwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
