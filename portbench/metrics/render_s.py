"""render_s: the window's seconds over the images it rendered, the image
in flight at the close included (host clock)."""


def read(rec):
    return rec["window_s"] / len(rec["units"])
