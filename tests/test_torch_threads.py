"""The port's CPU tests run torch on one compute thread
(tests/_torch_threads.py)."""

import torch

from _torch_threads import one_torch_thread  # noqa: F401


def test_port_tests_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1
