"""Camera data parallelism — the port of gps_slam_tpu/parallel/mesh.py.

Both paths take a list of devices and run in one process, without
`torch.distributed`: the JAX version is one controller over a device
`Mesh`, and a process group could hold only one rank on a one-card
machine.  A device may appear more than once (several replicas on one
card, or on the CPU).  A stacked camera batch splits into equal
contiguous chunks, chunk r on device r:

  * `dp_render` (`dp_render_fn`): each device renders its cameras with
    its own copy of the parameters; the images come back to the first
    device in camera order.  The >1-card path of the pipeline's eval
    renders (`SLAMPipeline._eval_render_batch`).
  * `dp_train_step` (`dp_train_step_fn`): each replica differentiates the
    mean loss over its cameras; the gradients are averaged over the
    replicas (the JAX `pmean`), one `WindowAdam` update runs on the first
    device's parameters, and every replica copies them again at its next
    step.
"""

from __future__ import annotations

import torch

from ..gs import losses
from ..gs.model import RenderStatics, ges_forward, render_eval_batch
from ..gs.optim import WindowAdam


def make_mesh(n: int | None = None, devices=None) -> list[torch.device]:
    """The first `n` of `devices` (default: every card) as torch.devices."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n or len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return devices[:n]


def _chunk(cam_batch: dict, n: int) -> int:
    M = len(cam_batch["c2w"])
    if M % n:
        raise ValueError(f"{M} cameras do not split over {n} devices")
    return M // n


def dp_render(devices: list[torch.device], params: dict, alive: torch.Tensor,
              cam_batch: dict, st: RenderStatics) -> dict:
    """Eval renders of a stacked camera batch (c2w, K, ref_depth,
    base_color, cam_id; as `render_eval_batch`) split over `devices`:
    stacked clipped rgb, alpha and depth on the first device."""
    m = _chunk(cam_batch, len(devices))
    outs = []
    for r, d in enumerate(devices):
        # camera ids stay where they are: the render reads them on the host
        local = {k: v[r * m:(r + 1) * m] if k == "cam_id" else v[r * m:(r + 1) * m].to(d)
                 for k, v in cam_batch.items()}
        outs.append(render_eval_batch({k: v.to(d) for k, v in params.items()},
                                      alive.to(d), local, st))
    return {k: torch.cat([o[k].to(devices[0]) for o in outs]) for k in outs[0]}


def dp_train_step(devices: list[torch.device], params: dict, alive: torch.Tensor,
                  opt: WindowAdam, cam_batch: dict, st: RenderStatics,
                  ssim_weight: float, return_grads: bool = False):
    """One data-parallel Adam step over a stacked camera batch (c2w, K,
    gt_rgb, ref_depth, base_color, cam_id) split over `devices`.  `params`
    are the leaf tensors `opt` updates in place; each replica renders with
    a copy of them, its loss the mean of `losses.compute_loss` (ssim weight
    as given, depth weight 0) over its cameras.  Returns the loss averaged
    over the replicas, on the parameters' device, and with `return_grads`
    also the averaged gradients the update took (name -> tensor)."""
    m = _chunk(cam_batch, len(devices))
    keys = list(params)
    dev0 = params[keys[0]].device
    rep_losses, rep_grads = [], []
    for r, d in enumerate(devices):
        rep = {k: v.detach().to(d, copy=True).requires_grad_(True)
               for k, v in params.items()}
        al = alive.to(d)
        vals = []
        for i in range(r * m, (r + 1) * m):
            res = ges_forward(rep, al, cam_batch["c2w"][i].to(d), cam_batch["K"][i].to(d),
                              cam_batch["ref_depth"][i].to(d),
                              cam_batch["base_color"][i].to(d),
                              int(cam_batch["cam_id"][i]), st)
            vals.append(losses.compute_loss(res["rgb"], res["depth"],
                                            cam_batch["gt_rgb"][i].to(d), None,
                                            ssim_weight, 0.0)["total"])
        loss = torch.stack(vals).mean()
        grads = torch.autograd.grad(loss, [rep[k] for k in keys], allow_unused=True)
        rep_grads.append([torch.zeros_like(rep[k]) if g is None else g
                          for k, g in zip(keys, grads)])
        rep_losses.append(loss.detach().to(dev0))
    grads = {k: torch.stack([g[j].to(dev0) for g in rep_grads]).mean(0)
             for j, k in enumerate(keys)}
    for k in keys:
        params[k].grad = grads[k]
    opt.step()
    opt.zero_grad()
    loss = torch.stack(rep_losses).mean()
    return (loss, grads) if return_grads else loss
