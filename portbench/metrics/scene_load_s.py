"""scene_load_s: the front end's load of the `.acn` scene (`run_file`),
by the harness's clock around it."""


def read(rec):
    return rec["scene_load_s"]
