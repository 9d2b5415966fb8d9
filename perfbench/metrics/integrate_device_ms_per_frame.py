"""integrate_device_ms_per_frame: the profiler's device time of K1
(integrate_cuda, csrc/integrate.cu) in the profiled slice, per frame of
the slice."""

KERNEL = "integrate_kernel"


def read(rec):
    t = rec.get("trace")
    if not t or not t["frames"]:
        return None
    secs = sum(v[0] for k, v in t["kernels"].items()
               if KERNEL in k and "integrate_f32" not in k)
    return secs * 1e3 / t["frames"] if secs > 0 else None
