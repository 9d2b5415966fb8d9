"""Frozen bound arithmetic: the chip's peaks and what a kernel has to
move at the least, copied from the port's own accounting (chip_smoke.py's
`bound_ms` and csrc/window_adam.cu's header) so that a later change to
the program cannot move the yardstick.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12      # HBM3
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
H100_F64_FLOP_PER_S = 34e12     # f64 outside the tensor cores

# window_adam_cuda: per element it reads p, g, mu and nu and writes p, mu
# and nu, 7 f32 words
ADAM_BYTES_PER_ELEMENT = 28


def gaussian_row_elements(sh_degree: int) -> int:
    """f32 elements of one optimised Gaussian row: means 3, quats 4,
    scales 3, opacity 1, SH DC 3 and 3 x ((d + 1)^2 - 1) SH rest."""
    return 3 + 4 + 3 + 1 + 3 + 3 * ((sh_degree + 1) ** 2 - 1)


# the exposure affine the pool always keeps (one [3, 4] per camera, at
# least one), updated with the rows
EXPOSURE_ELEMENTS = 12


def adam_elements(rows: int, sh_degree: int, cameras: int = 1) -> int:
    """Elements one window_adam_cuda launch over `rows` rows updates."""
    return rows * gaussian_row_elements(sh_degree) + EXPOSURE_ELEMENTS * max(cameras, 1)


def adam_bytes(rows: int, sh_degree: int, cameras: int = 1) -> int:
    """Least bytes one window_adam_cuda launch over `rows` rows moves."""
    return ADAM_BYTES_PER_ELEMENT * adam_elements(rows, sh_degree, cameras)


def bound_s(n_bytes: float, n_ops: float = 0.0, n_f64_ops: float = 0.0) -> tuple:
    """(least seconds, what bounds it) of a launch that moves `n_bytes`
    and runs `n_ops` f32 and `n_f64_ops` f64 operations."""
    t = {"bytes": n_bytes / H100_BYTES_PER_S, "f32 ops": n_ops / H100_F32_FLOP_PER_S,
         "f64 ops": n_f64_ops / H100_F64_FLOP_PER_S}
    by = max(t, key=t.get)
    return t[by], by


def roofline_pct(n_bytes: float, device_s: float, n_ops: float = 0.0) -> float | None:
    """A kernel's share of its roofline, in %: its least time over its
    measured device time.  None without device time."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s(n_bytes, n_ops)[0] / device_s
