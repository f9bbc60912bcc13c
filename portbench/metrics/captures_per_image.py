"""captures_per_image: per image, the program's counter
`graphs.captures` (CUDA graphs captured in the render call), the mean
over the window.  None where the program keeps no record (records.py)."""

import records


def read(rec):
    got = records.per_unit(rec)
    if got is None:
        return None
    return sum(p["counters"].get("graphs.captures", 0)
               for p in got) / len(got)
