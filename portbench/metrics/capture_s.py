"""capture_s: per image, the program's spans `graphs.capture` (each a
drain stage's warm-up trip, then its CUDA-graph capture and the
synchronise after it: actinon_tpu_torch/render/graphs.py), summed, the
mean over the window.  None where the program keeps no record
(records.py)."""

import records


def read(rec):
    got = records.per_unit(rec)
    if got is None:
        return None
    return sum(end - start for p in got
               for name, start, end, _ in p["spans"]
               if name == "graphs.capture") / len(got)
