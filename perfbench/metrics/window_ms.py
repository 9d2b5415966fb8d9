"""window_ms: SLAMPipeline.t_opt gained over the window per optimisation
window run in it (each ends in the read of its counts)."""


def read(rec):
    w = rec["window"]
    return w["t_opt_ms"] / w["windows"] if w["windows"] else None
