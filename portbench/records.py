"""The program's own record of each image of the traced window: the
`stats` dict that each `render_scene` call filled (spans, counters and
device_spans: actinon_tpu_torch/render/spans.py).  The harness keeps
only some of its numbers in a unit; the program itself keeps the whole
dict of each call made while a torch profiler records, newest last, in
`spans.profiled`, and the traced window is such a time."""

from __future__ import annotations

import sys

MODULE = "actinon_tpu_torch.render.spans"


def per_unit(rec):
    """Each unit's record, in the units' order, or None where the program
    keeps none: an older program, or a unit with no call of its own
    there (each pairs with one call by the pass loop's seconds, which
    the unit keeps too)."""
    units = rec["units"]
    kept = list(getattr(sys.modules.get(MODULE), "profiled", ()))
    if not units or len(kept) < len(units):
        return None
    got = kept[-len(units):]
    if any(p.get("seconds") != u["seconds"] for p, u in zip(got, units)):
        return None
    return got
