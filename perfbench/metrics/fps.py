"""fps: every frame completed in the timed window over the window's
seconds (host clock; the window ends in a synchronise)."""


def read(rec):
    w = rec["window"]
    return w["frames"] / w["seconds"] if w["frames"] else None
