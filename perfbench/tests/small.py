"""The CPU tests' small cells: the benchmark's configs and traffic at
320x180 with 2 cm voxels (a quarter of the cells' frame and four times
their voxel: the same voxels a pixel), small pools, a short set-up."""

SMALL = {
    "config": {
        "READER": {"image_shape": [320, 180], "intrinsics": [160.0, 160.0, 159.5, 89.5]},
        "PIPE": {"TSDF": {"voxel_size": 0.02, "trunc_dist": 0.08}, "local_opt_iters": 4},
        "TPU": {"gaussian_capacity": 2 ** 14, "hash_size": 2 ** 16, "block_capacity": 2 ** 13,
                "visible_block_capacity": 2 ** 12, "alloc_candidate_cap": 2 ** 12,
                "max_new_gaussians": 2 ** 11, "visible_gaussian_cap": 2 ** 13,
                "max_isects": 2 ** 17, "tile_gaussian_cap": 64},
    },
    "traffic": {"period_frames": 600, "warmup_frames": 12, "trace_frames": 4},
}


def merge(d: dict, over: dict) -> None:
    """Deep update of d by over, in place."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            merge(d[k], v)
        else:
            d[k] = v


def small_cell(workload: str):
    """The cell `workload` of BENCHMARK.json at the small sizes."""
    from pbench.cell import Cell

    cell = Cell(workload)
    merge(cell.config_file["config"], SMALL["config"])
    cell.traffic.update(SMALL["traffic"])
    return cell
