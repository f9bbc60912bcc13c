"""Detectors of what a CUDA-graph capture refuses, for the CPU tests of
the port's captured paths (tests/test_torch_drain.py: a drain trip;
tests/test_torch_diff_graph.py: the diff replay and its backward).

They run on the `meta` device, which holds no data, so a host read
raises there; the dispatch mode sees every copy from the host, and the
function mode every tensor made from a host value, which the meta device
makes in place and so hides."""

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class _Uploads(TorchDispatchMode):
    """Records every op that reads a host tensor (a copy from the host
    into the meta tensors)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat, _ = tree_flatten((args, kwargs or {}))
        if any(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in flat):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _host_index(index):
    """An index holds a list or an array: torch makes it a host tensor
    and copies it to the device."""
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, (list, np.ndarray)) for i in parts)


class _Scalars(TorchFunctionMode):
    """Records every tensor made from host data, every element write of a
    host value, and every index by a list or an array: on the card each
    is a copy from the host, which a CUDA graph capture refuses (the
    meta device makes them in place)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.as_tensor, torch.tensor, torch.asarray)
                and not isinstance(args[0], torch.Tensor)) \
                or (func is torch.Tensor.__setitem__
                    and not isinstance(args[2], torch.Tensor)) \
                or (func in (torch.Tensor.__getitem__,
                             torch.Tensor.__setitem__)
                    and _host_index(args[1])):
            self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


# ops that read the device back to decide something on the host: on the
# meta device some of them do nothing (a linalg error check) and so pass
_READS = ("aten._linalg_check_errors", "aten._local_scalar_dense",
          "aten.nonzero", "aten.masked_select", "aten.is_nonzero",
          "aten._unique2", "aten.unique_consecutive", "aten.equal")


class _Reads(TorchDispatchMode):
    """Records every op that reads the device back to the host (a sync on
    a card, which a CUDA-graph capture refuses)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).rsplit(".", 1)[0] in _READS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))
