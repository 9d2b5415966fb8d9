"""window_adam_roofline: window_adam_cuda's share of its roofline in the
profiled slice, in %: the least bytes of its launches (28 B an element;
a launch updates the window's opt prefix of rows, 3 + 4 + 3 + 1 + 3 +
3((d+1)^2 - 1) elements a row, and the 12-element exposure affine) over
HBM's 3.35 TB/s, over the profiler's device time of the kernel.  The
profiler can drop a few of a long slice's records (237 of 240 launches
in a 120-frame slice on an H100): the bytes are then those of an
average step of the slice times the launches it recorded.  Nothing to
read without a launch."""

from pbench import bounds

KERNEL = "window_adam_kernel"


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items() if KERNEL in k)
    launches = sum(v[1] for k, v in t["kernels"].items() if KERNEL in k)
    steps = sum(n for _, n in t["windows"])
    if launches == 0 or secs <= 0 or steps == 0:
        return None
    n_bytes = sum(n * bounds.adam_bytes(cap, rec["sh_degree"]) for cap, n in t["windows"])
    return bounds.roofline_pct(n_bytes * launches / steps, secs)
