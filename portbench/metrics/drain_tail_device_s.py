"""drain_tail_device_s: per image, the device seconds of the drain's
stage replays whose batch is below the cell's (the cascade's
under-filled stages), from the program's CUDA events around each replay
(`device_spans`: actinon_tpu_torch/render/spans.py), summed, the mean
over the window.  None where the program keeps no record (records.py),
or where an image made no replay (no card)."""

import records


def read(rec):
    got = records.per_unit(rec)
    if got is None or not all(p["device_spans"] for p in got):
        return None
    batch = rec["cell"].batch
    return sum(s for p in got for k, s in p["device_spans"]
               if k < batch) / len(got)
