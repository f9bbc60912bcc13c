"""actinon-tpu on PyTorch and CUDA: the CSG path tracer of `actinon_tpu`,
ported to one NVIDIA H100.

The same pipeline as the JAX package — the `.acn` front end
(`actinon_tpu_torch.acn`), the array IR (`actinon_tpu_torch.scene`), the
wavefront tracer, integrator and driver (`actinon_tpu_torch.render`) —
on torch tensors, with the Pallas kernels of the main path rewritten by
hand in CUDA C++ for Hopper (`csrc/trace_kernels.cu`).  It imports
nothing of the JAX package; it keeps its own copies of the pure-Python
modules it needs.  Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

import torch as _torch

# Every contraction here is a small 3-vector or table reduction whose
# accuracy decides visibility: keep f32 products exact (no TF32), as the
# JAX package forces "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from actinon_tpu_torch.config import RenderConfig, FType

__version__ = "0.1.0"
