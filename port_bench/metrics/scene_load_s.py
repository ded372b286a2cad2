"""Seconds of `load_scene` (parse, OBJ reading, tables, BVH build where
the scene has one) and the configuration's overrides, by the host clock
in the harness."""


def read(rec):
    return rec["scene_load_s"]
