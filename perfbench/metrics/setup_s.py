"""``setup_s``: host seconds from the process's start to the first timed
graph (imports, kernel build or load, inputs, the program's graph build,
plans, the cold and warm runs)."""


def read(rec):
    return rec["setup_s"]
