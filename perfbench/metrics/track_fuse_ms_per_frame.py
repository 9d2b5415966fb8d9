"""track_fuse_ms_per_frame: SLAMPipeline.t_fusion gained over the window,
per frame, on the tracked route, where each frame's step is the tracked
megastep (ICP, revert, fusion, the next prepare raycast) and one read."""


def read(rec):
    w = rec["window"]
    if not rec["tracked"] or not w["frames"]:
        return None
    return w["t_fusion_ms"] / w["frames"]
