"""Artifact IO: pose txt, PLY point clouds / meshes / 3DGS models,
cameras.json, cfg_args — byte-format-compatible with the reference so its
eval scripts and third-party 3DGS/SIBR viewers work unchanged.

Reference counterparts: src/file_utils.cpp (pose txt, cfg_args),
src/raw_gs_param.cpp:159-218 (binary 3DGS PLY), src/dataset_reader.cpp:12-84
(tinyply point-cloud read) and :420-460 (saveCameras JSON),
InfiniTAM/ITMLib/Objects/Meshing/ITMMesh.h (mesh PLY).
"""

from __future__ import annotations

import json
import os

import numpy as np


# ---------------------------------------------------------------------------
# pose txt
# ---------------------------------------------------------------------------

def read_pose_txt(path: str) -> np.ndarray:
    """Read a whitespace-separated 4x4 pose matrix (reference
    src/file_utils.cpp readMatrixFromTXT)."""
    mat = np.loadtxt(path, dtype=np.float64).reshape(4, 4)
    return mat.astype(np.float32)


def save_pose_txt(pose: np.ndarray, path: str) -> None:
    """Write a 4x4 pose matrix as text (reference src/file_utils.cpp:229-256
    saveTensorTXT)."""
    np.savetxt(path, np.asarray(pose).reshape(4, 4), fmt="%.9f")


def id_to_filename(frame_id: int, width: int = 6) -> str:
    """6-digit zero-padded id (reference src/file_utils.cpp:143-148)."""
    return f"{frame_id:0{width}d}"


# ---------------------------------------------------------------------------
# point-cloud PLY (read: init point clouds; reference Points::readPly)
# ---------------------------------------------------------------------------

def read_ply_points(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read xyz + rgb from a binary-little-endian or ascii PLY point cloud.

    Returns (xyz [N,3] float32, rgb [N,3] float32 in [0,1]).
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    lines = [l.strip() for l in header.splitlines()]
    fmt = "binary_little_endian"
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in lines:
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            _, name, cnt = line.split()
            in_vertex = name == "vertex"
            if in_vertex:
                n_vertex = int(cnt)
        elif line.startswith("property") and in_vertex:
            _, typ, name = line.split()
            props.append((typ, name))

    type_map = {
        "float": "f4", "float32": "f4", "double": "f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "i2", "ushort": "u2", "int": "i4", "uint": "u4",
    }
    if fmt == "ascii":
        body = np.loadtxt(
            [l for l in data[header_end:].decode().splitlines() if l.strip()],
            dtype=np.float64,
        ).reshape(n_vertex, len(props))
        cols = {name: body[:, i] for i, (_, name) in enumerate(props)}
    else:
        dtype = np.dtype([(name, "<" + type_map[typ]) for typ, name in props])
        arr = np.frombuffer(data, dtype=dtype, count=n_vertex, offset=header_end)
        cols = {name: arr[name] for _, name in props}

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    if "red" in cols:
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1).astype(
            np.float32
        )
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb


# ---------------------------------------------------------------------------
# 3DGS binary PLY (write: viewer-compatible Gaussian model dump)
# ---------------------------------------------------------------------------

def save_gaussian_ply(
    path: str,
    means: np.ndarray,
    scales_log: np.ndarray,
    quats: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacities_logit: np.ndarray,
) -> None:
    """Write the standard 3DGS binary PLY layout (reference
    src/raw_gs_param.cpp:159-218 savePly): x,y,z, nx,ny,nz (zeros),
    f_dc_0..2, f_rest_0..(3K-4) channel-major, opacity (logit),
    scale_0..2 (log), rot_0..3."""
    n = means.shape[0]
    k_rest = features_rest.shape[1] if features_rest.ndim == 3 else 0
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    names += [f"f_rest_{i}" for i in range(3 * k_rest)]
    names += ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]

    header = "ply\nformat binary_little_endian 1.0\n"
    header += f"element vertex {n}\n"
    header += "".join(f"property float {name}\n" for name in names)
    header += "end_header\n"

    # f_rest is stored channel-major: all of channel 0's K-1 coeffs, then
    # channel 1, then channel 2 (3DGS convention; reference transposes via
    # featuresRest.transpose(1,2).flatten at raw_gs_param.cpp:193).
    rest_cm = (
        features_rest.transpose(0, 2, 1).reshape(n, -1)
        if k_rest > 0
        else np.zeros((n, 0), np.float32)
    )
    body = np.concatenate(
        [
            means.astype(np.float32),
            np.zeros((n, 3), np.float32),
            features_dc.astype(np.float32),
            rest_cm.astype(np.float32),
            opacities_logit.reshape(n, 1).astype(np.float32),
            scales_log.astype(np.float32),
            quats.astype(np.float32),
        ],
        axis=1,
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(body, dtype="<f4").tobytes())


# ---------------------------------------------------------------------------
# 3DGS binary PLY (read: open a reference-/3DGS-trained model)
# ---------------------------------------------------------------------------

def load_gaussian_ply(path: str) -> dict:
    """Read a 3DGS binary PLY (the layout savePly writes,
    raw_gs_param.cpp:159-218) back into the parameter dict: means [N,3],
    scales (log) [N,3], quats [N,4], features_dc [N,3], features_rest
    [N,K-1,3] (channel-major f_rest_* de-interleaved), opacities (logit)
    [N].  Lets eval mode / the viewer open a model trained by the CUDA
    reference or by stock 3DGS."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    n = 0
    names: list[str] = []
    for line in header.splitlines():
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and t[1] == "float":
            names.append(t[2])
    dtype = np.dtype([(name, "<f4") for name in names])
    arr = np.frombuffer(data, dtype=dtype, count=n, offset=header_end)

    def col(*cs):
        return np.stack([arr[c] for c in cs], -1).astype(np.float32)

    n_rest = sum(1 for name in names if name.startswith("f_rest_"))
    k_rest = n_rest // 3
    if k_rest > 0:
        rest_cm = np.stack(
            [arr[f"f_rest_{i}"] for i in range(3 * k_rest)], -1
        ).astype(np.float32)
        # stored channel-major (all of channel 0's K-1 coeffs first);
        # de-interleave back to [N, K-1, 3]
        rest = rest_cm.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), np.float32)
    return {
        "means": col("x", "y", "z"),
        "scales": col("scale_0", "scale_1", "scale_2"),
        "quats": col("rot_0", "rot_1", "rot_2", "rot_3"),
        "features_dc": col("f_dc_0", "f_dc_1", "f_dc_2"),
        "features_rest": rest,
        "opacities": arr["opacity"].astype(np.float32),
    }


# ---------------------------------------------------------------------------
# model.pt (torch-archive interop with the reference's saveTensor/loadTensor)
# ---------------------------------------------------------------------------

# our snake_case param keys <-> the reference's archive names
# (raw_gs_param.cpp:222-230)
_PT_NAMES = {
    "means": "means", "scales": "scales", "quats": "quats",
    "features_dc": "featuresDc", "features_rest": "featuresRest",
    "opacities": "opacities", "exposure": "exposure",
}


def save_model_pt(path: str, params: dict) -> None:
    """Write model.pt as a TorchScript-module archive whose named buffers
    match the reference's torch::serialize::OutputArchive layout
    (raw_gs_param.cpp:220-238), so RawGaussianParams::loadTensor can
    archive.read() each tensor by name.  The reference stores opacities as
    [N,1]; ours is [N] and is expanded on write."""
    import torch

    mod = torch.nn.Module()
    for ours, theirs in _PT_NAMES.items():
        if ours not in params:
            continue
        v = np.asarray(params[ours], np.float32)
        if ours == "opacities" and v.ndim == 1:
            v = v[:, None]
        # .copy() guarantees a writable owned buffer (torch rejects
        # read-only views with a warning)
        mod.register_buffer(theirs, torch.from_numpy(
            np.ascontiguousarray(v).copy()))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.jit.script(mod).save(path)


def load_model_pt(path: str) -> dict:
    """Read a model.pt written by save_model_pt OR by the reference's
    saveTensor (both are TorchScript archives with the same buffer names).
    Returns our snake_case param dict (opacities squeezed to [N])."""
    import torch

    mod = torch.jit.load(path, map_location="cpu")
    found = {name: buf for name, buf in mod.named_buffers()}
    # C++ OutputArchive::write stores plain attributes, not buffers —
    # fall back to attribute lookup for reference-written archives
    out = {}
    for ours, theirs in _PT_NAMES.items():
        t = found.get(theirs)
        if t is None:
            t = getattr(mod, theirs, None)
        if t is None:
            continue
        v = t.detach().cpu().numpy().astype(np.float32)
        if ours == "opacities":
            v = v.reshape(v.shape[0])
        out[ours] = v
    return out


# ---------------------------------------------------------------------------
# mesh PLY
# ---------------------------------------------------------------------------

def save_mesh_ply(path: str, vertices: np.ndarray, colors: np.ndarray | None = None,
                  faces: np.ndarray | None = None) -> None:
    """Write a triangle mesh. If `faces` is None, vertices are interpreted
    as packed triangles [3*T, 3] and an implicit face list is generated
    (matching InfiniTAM's triangle-soup PLY writer,
    Objects/Meshing/ITMMesh.h WritePLY)."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    n = vertices.shape[0]
    if faces is None:
        faces = np.arange(n, dtype=np.int32).reshape(-1, 3)
    has_color = colors is not None
    if has_color:
        colors = np.clip(np.asarray(colors).reshape(-1, 3) * 255.0, 0, 255).astype(np.uint8)

    header = "ply\nformat binary_little_endian 1.0\n"
    header += f"element vertex {n}\n"
    header += "property float x\nproperty float y\nproperty float z\n"
    if has_color:
        header += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
    header += f"element face {faces.shape[0]}\n"
    header += "property list uchar int vertex_index\nend_header\n"

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if has_color:
            vtype = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            varr = np.empty(n, dtype=vtype)
            varr["xyz"] = vertices
            varr["rgb"] = colors
            f.write(varr.tobytes())
        else:
            f.write(np.ascontiguousarray(vertices, dtype="<f4").tobytes())
        ftype = np.dtype([("cnt", "u1"), ("idx", "<i4", 3)])
        farr = np.empty(faces.shape[0], dtype=ftype)
        farr["cnt"] = 3
        farr["idx"] = faces
        f.write(farr.tobytes())


def read_mesh_ply(path: str) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """Read a binary PLY mesh -> (vertices, colors or None, faces)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    n_vertex = n_face = 0
    vprops: list[tuple[str, str]] = []
    cur = None
    for line in header.splitlines():
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "element":
            cur = t[1]
            if cur == "vertex":
                n_vertex = int(t[2])
            elif cur == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex" and t[1] != "list":
            vprops.append((t[1], t[2]))
    type_map = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1", "uint8": "u1"}
    vdtype = np.dtype([(name, "<" + type_map[typ]) for typ, name in vprops])
    varr = np.frombuffer(data, dtype=vdtype, count=n_vertex, offset=header_end)
    vertices = np.stack([varr["x"], varr["y"], varr["z"]], -1).astype(np.float32)
    colors = None
    if "red" in vdtype.names:
        colors = np.stack([varr["red"], varr["green"], varr["blue"]], -1).astype(np.float32) / 255.0
    off = header_end + vdtype.itemsize * n_vertex
    fdtype = np.dtype([("cnt", "u1"), ("idx", "<i4", 3)])
    farr = np.frombuffer(data, dtype=fdtype, count=n_face, offset=off)
    return vertices, colors, farr["idx"].astype(np.int32)


# ---------------------------------------------------------------------------
# cameras.json + cfg_args (SIBR / 3DGS viewer compatibility)
# ---------------------------------------------------------------------------

def save_cameras_json(cams, path: str) -> None:
    """reference src/dataset_reader.cpp:420-460 saveCameras."""
    out = []
    for i, cam in enumerate(cams):
        c2w = np.asarray(cam.c2w_slam)
        out.append(
            {
                "id": i,
                "img_name": os.path.basename(cam.img_file_path),
                "width": cam.width,
                "height": cam.height,
                "fx": cam.fx,
                "fy": cam.fy,
                "position": c2w[:3, 3].tolist(),
                "rotation": c2w[:3, :3].tolist(),
            }
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)


def save_cfg_args(path: str, sh_degree: int = 3, white_background: bool = False) -> None:
    """3DGS-viewer compatibility stub (reference src/file_utils.cpp:163-170)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "Namespace(data_device='cuda', eval=True, images='images', "
            f"model_path='', resolution=-1, sh_degree={sh_degree}, "
            f"source_path='', white_background={white_background})"
        )
