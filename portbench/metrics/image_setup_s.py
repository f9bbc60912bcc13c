"""image_setup_s: per image, the wall of the `render_scene` call less its
own `stats["seconds"]` (which start once `compile_scene`, the Tracer and
the Integrator are built), the mean over the window."""


def read(rec):
    u = rec["units"]
    return sum(x["wall_s"] - x["seconds"] for x in u) / len(u)
