#!/usr/bin/env python
"""CLI entry point of the PyTorch/CUDA port — the same interface as
slam_trainer.py: `python slam_trainer_torch.py <config.yaml> [--device D]`
with work_mode train | recon | eval.

train: online SLAM (TSDF fusion + Gaussian spawn, Adam window and
       prune), with gt poses or, with PIPE.TSDF.use_gt_pose false, the
       tracker of PIPE.TSDF.tracker (ICP by default); then save model /
       mesh / engine / poses and optionally render eval images.
recon: TSDF-only fusion (no Gaussians), then save mesh / engine / poses.
eval:  load a saved model + TSDF engine and render evaluation images.

Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse

from gps_slam_torch.config import Config, create_workspace
from gps_slam_torch.data.reader import DatasetReader
from gps_slam_torch.gs.model import GaussianModel
from gps_slam_torch.slam.pipeline import SLAMPipeline
from gps_slam_torch.slam.tracker import make_tracker
from gps_slam_torch.tsdf.engine import TsdfEngine


def main(config_path: str, device=None) -> None:
    cfg = Config.from_yaml(config_path)
    ws = create_workspace(cfg, config_path)
    reader = DatasetReader(cfg.reader)
    reader.read()
    reader.update_scene_geo()
    train_cams = reader.train_vec
    if not train_cams:
        raise RuntimeError("no cameras read")
    cam0 = train_cams[0]
    engine = TsdfEngine(cfg, cam0.width, cam0.height, cam0.K, device=device)
    if cfg.pipe.tsdf.use_gt_pose:
        engine.set_gt_poses([c.c2w for c in train_cams])
        engine.turn_off_tracking()
    else:
        engine.attach_tracker(make_tracker(cfg, cam0.width, cam0.height))
    model = GaussianModel(cfg, cam0.width, cam0.height,
                          exposure_num=len(train_cams) if cfg.model.use_exposure else 0,
                          device=engine.device)
    pipe = SLAMPipeline(cfg, engine, ws, is_train=cfg.work_mode != "eval")
    pipe.scene_scale = reader.scene_scale

    if cfg.work_mode in ("train", "recon"):
        pipe.slam_train_cams(model, train_cams)
        if cfg.pipe.save_after_train:
            if cfg.work_mode == "train":
                pipe.save(model, reader)
            pipe.save_mesh()
            pipe.save_engine()
            reader.save_pose(ws + "/pose")
        if cfg.pipe.eval_after_train and cfg.work_mode == "train":
            pipe.render_eval_imgs(model, reader.val_vec, ("rgb", "alpha", "depth"))
    elif cfg.work_mode == "eval":
        model.load(pipe.model_path)
        pipe.load_engine()
        for cam in train_cams:
            if cam.id < len(engine.cam_poses):
                cam.c2w_slam = engine.cam_poses[cam.id]
        pipe.render_eval_imgs(model, reader.val_vec, ("rgb", "alpha", "depth"))
    else:
        raise ValueError(f"unknown work_mode: {cfg.work_mode}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    args = ap.parse_args()
    main(args.config, args.device)
