"""setup_s: process start to the start of the first timed step (imports,
the frames made on the card, the kernels' build where it runs, the
graphs' captures and the first windows)."""


def read(rec):
    return rec["setup_s"]
