"""fusion_ms_per_frame: SLAMPipeline.t_fusion gained over the window, per
frame, on the gt-pose route (each fusion group timed to its synchronise).
Nothing to read on the tracked route."""


def read(rec):
    w = rec["window"]
    if rec["tracked"] or not w["frames"]:
        return None
    return w["t_fusion_ms"] / w["frames"]
