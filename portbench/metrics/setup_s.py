"""setup_s: process start to the first timed unit: imports, CUDA
set-up, the kernel library, the scene load and one warm-up unit (host
clock)."""


def read(rec):
    return rec["setup_s"]
