"""window_captures: CUDA graph captures of the window megastep
(WindowGraphs.captures) gained in the timed window.  Nothing to read
where no window runs (work_mode recon)."""


def read(rec):
    if rec["work_mode"] == "recon":
        return None
    return rec["window"]["captures"]
