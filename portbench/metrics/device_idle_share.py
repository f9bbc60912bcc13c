"""device_idle_share: 100 (1 - busy / wall) over the traced window.  Busy: the graph replays' CUDA-event spans and
the profiler's device time of what ran outside any replay."""


def read(rec):
    if "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
