"""host_reads_per_image: per image, the program's counter
`drain.host_reads` (the device drain's reads of its count, one a
stage, over the call's passes), the mean over the window.  None where
the program keeps no record (records.py)."""

import records


def read(rec):
    got = records.per_unit(rec)
    if got is None:
        return None
    return sum(p["counters"].get("drain.host_reads", 0)
               for p in got) / len(got)
