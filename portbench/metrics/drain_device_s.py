"""drain_device_s: per image, the summed CUDA-event spans of every
`torch.cuda.CUDAGraph.replay` during it (the graph drain's device time),
the mean over the traced window."""


def read(rec):
    u = rec["units"]
    if not u or "replay_s" not in u[0]:
        return None
    return sum(x["replay_s"] for x in u) / len(u)
