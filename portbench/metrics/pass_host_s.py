"""pass_host_s: per image, the program's spans of the driver's own pass
work on the host (`driver.positions`: pass 0's pixel centres or the
gradient pass's squared gradient and LCG draws; `driver.accumulate`:
saturation and the accumulator; `driver.output`: the averaged image, the
PNM and the hash), summed, the mean over the window.  None where the
program keeps no record (records.py)."""

import records

NAMES = ("driver.positions", "driver.accumulate", "driver.output")


def read(rec):
    got = records.per_unit(rec)
    if got is None:
        return None
    return sum(end - start for p in got
               for name, start, end, _ in p["spans"]
               if name in NAMES) / len(got)
