"""Plain reference of opt_camera's training step: the poses' transforms, the
soft silhouettes of the candidate poses, the IoU loss summed over the
poses, and Adam.  It imports nothing of the program; ``follow`` takes the
problem as the benchmark hands it to both sides (the mesh file, the goal
poses, the starting poses and the settings) and works out the goal
silhouettes itself."""

from __future__ import annotations

import torch

from benchmark.reference import geometry as G
from benchmark.reference import raster as R
from benchmark.reference.adam import Adam


def camera_vertices(v, poses, extra=None):
    """The screen-space vertices [B, nv, 3] of v [nv, 3] under poses [B, 4]
    (distance, elevation, azimuth, fov), after a rotation by the poses
    extra where given."""
    B = poses.shape[0]
    x = v[None].expand(B, -1, -1)
    if extra is not None:
        x = G.look_at(x, G.points_from_angles(extra[:, 0], extra[:, 1],
                                              extra[:, 2]), only_rotate=True)
    x = G.look_at(x, G.points_from_angles(poses[:, 0], poses[:, 1],
                                          poses[:, 2]))
    return G.perspective(x, poses[:, 3])


def iou_loss_sum(pred, target):
    inter = (pred * target).sum((1, 2))
    union = (pred + target - pred * target).sum((1, 2)) + 1e-6
    return (1.0 - inter / union).sum()


def follow(obj_path, goal_poses, poses0, cfg, tau, steps, device,
           dtype=torch.float32):
    """Steps of opt_camera from poses0 at tau: dict(losses [steps],
    grads {'poses': the first step's gradient}, change {'poses': the
    poses after ``steps`` minus poses0}), computed in dtype."""
    v, f = G.read_obj(obj_path)
    v = torch.as_tensor(v, device=device, dtype=dtype)
    f = torch.as_tensor(f, device=device)
    S = cfg['image_size']
    goal_poses = torch.as_tensor(goal_poses, device=device, dtype=dtype)
    goal = R.hard_alpha(R.face_xy(camera_vertices(v, goal_poses), f), S)
    poses = torch.as_tensor(poses0, device=device, dtype=dtype).clone()
    opt = Adam([poses], cfg['learning_rate'], tuple(cfg['betas']))
    losses, first = [], None
    for _ in range(steps):
        p = poses.detach().requires_grad_(True)
        xy = R.face_xy(camera_vertices(v, p, goal_poses), f)
        alpha = R.soft_alpha(xy, S, cfg['dist_func'], tau, cfg['dist_eps'])
        loss = iou_loss_sum(alpha, goal)
        g, = torch.autograd.grad(loss, p)
        losses.append(float(loss.detach()))
        first = g if first is None else first
        opt.step([g])
    p0 = torch.as_tensor(poses0, device=device, dtype=dtype)
    return dict(losses=losses, grads={'poses': first.float()},
                change={'poses': (poses - p0).float()})
