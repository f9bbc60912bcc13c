"""image_build_s: per image, the program's own spans of the render
call's build and release of its scene, tracer and integrator
(`driver.compile`, `driver.tracer`, `driver.integrator`,
`driver.release`: actinon_tpu_torch/render/spans.py), summed, the mean
over the window: the in-program counterpart of image_setup_s.  None
where the program keeps no record (records.py)."""

import records

NAMES = ("driver.compile", "driver.tracer", "driver.integrator",
         "driver.release")


def read(rec):
    got = records.per_unit(rec)
    if got is None:
        return None
    return sum(end - start for p in got
               for name, start, end, _ in p["spans"]
               if name in NAMES) / len(got)
