"""Keyframed camera paths and offline path rendering.

PyTorch port of deblur4dgs_tpu/vis/render_panel.py (the reference's viser
render tab, flow3d/vis/render_panel.py:37-1165, as a plain library): a
Kochanek-Bartels spline (render_panel.py:158-178, tension at :535)
interpolates a smooth camera path through the keyframes, optionally
looped (:510); per-keyframe fov and time (scene frame) are interpolated
alongside (:67-118), and the path renders to a video.

Rotations use the interpolating C1 quaternion spline (squad with
Kochanek-Bartels-scaled inner tangents) over quaternions aligned to one
hemisphere; translations, fov and time use cubic Hermite with the same
tangent rule, so tension 0 is Catmull-Rom and the path passes through
every keyframe. The path math runs on the CPU in float32 (a few dozen
4x4 matrices); the frames render on the renderer's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deblur4dgs_tpu_torch.ops import lie


@dataclass
class Keyframe:
    """One camera keyframe (render_panel.py:67-118).

    c2w: (4, 4) camera-to-world. fov: vertical field of view (radians).
    time: scene frame index rendered at this keyframe, or None (sharp
    canonical rendering / static scenes).
    """

    c2w: np.ndarray
    fov: float = np.pi / 3
    time: float | None = None


def _align_quats(qs: torch.Tensor) -> torch.Tensor:
    """Flip signs so consecutive quaternions lie in the same hemisphere."""
    out, prev = [], qs[0]
    for q in qs:
        q = torch.where(torch.sum(prev * q) < 0.0, -q, q)
        out.append(q)
        prev = q
    return torch.stack(out)


def _kb_tangents(x: torch.Tensor, loop: bool, tension: float) -> torch.Tensor:
    """Kochanek-Bartels tangents (continuity = bias = 0): (K, ...) values
    -> (K, ...) tangents m_i = (1 - tension)/2 (x_{i+1} - x_{i-1}), with
    one-sided ends, or wrapping around when looped."""
    if loop:
        nxt = torch.roll(x, -1, dims=0)
        prv = torch.roll(x, 1, dims=0)
        return 0.5 * (1.0 - tension) * (nxt - prv)
    inner = 0.5 * (x[2:] - x[:-2])
    first = (x[1] - x[0])[None]
    last = (x[-1] - x[-2])[None]
    return (1.0 - tension) * torch.cat([first, inner, last], dim=0)


def _hermite(x0, x1, m0, m1, u):
    """Cubic Hermite: values / tangents (...,), u (N, 1) -> (N, ...)."""
    u2 = u * u
    u3 = u2 * u
    h00 = 2 * u3 - 3 * u2 + 1
    h10 = u3 - 2 * u2 + u
    h01 = -2 * u3 + 3 * u2
    h11 = u3 - u2
    return h00 * x0 + h10 * m0 + h01 * x1 + h11 * m1


def _slerp(q0, q1, u):
    r = lie.quat_log(lie.quat_mul(lie.quat_conj(q0), q1))
    return lie.quat_mul(q0.expand(u.shape[:-1] + (4,)), lie.quat_exp(u * r))


def _squad_inner(qs: torch.Tensor, loop: bool, tension: float) -> torch.Tensor:
    """Inner control quats s_i = q_i exp(-(1-t)(log(q_i^-1 q_{i+1}) +
    log(q_i^-1 q_{i-1}))/4) of the interpolating squad spline."""
    if loop:
        nxt = torch.roll(qs, -1, dims=0)
        prv = torch.roll(qs, 1, dims=0)
    else:
        nxt = torch.cat([qs[1:], qs[-1:]], dim=0)
        prv = torch.cat([qs[:1], qs[:-1]], dim=0)
    inv = lie.quat_conj(qs)
    r = lie.quat_log(lie.quat_mul(inv, nxt)) + lie.quat_log(
        lie.quat_mul(inv, prv))
    return lie.quat_mul(qs, lie.quat_exp(-0.25 * (1.0 - tension) * r))


def _frames_per_segment(pos: torch.Tensor, nseg: int,
                        num_frames: int) -> np.ndarray:
    """Frames of each segment, in proportion to its chord (about constant
    travel speed, as the reference's spline_t arc parameterization), each
    at least one, summing to num_frames."""
    chord = torch.linalg.norm(torch.roll(pos, -1, dims=0) - pos,
                              dim=-1).numpy()[:nseg]
    weights = np.maximum(chord, 1e-6)
    alloc = np.maximum(
        1, np.round(weights / weights.sum() * num_frames).astype(int))
    # trim / extend to exactly num_frames (the largest segments absorb it)
    order = np.argsort(-alloc)
    i = 0
    while alloc.sum() > num_frames:
        if alloc[order[i % nseg]] > 1:
            alloc[order[i % nseg]] -= 1
        i += 1
    i = 0
    while alloc.sum() < num_frames:
        alloc[order[i % nseg]] += 1
        i += 1
    return alloc


def interpolate_camera_path(
    keyframes: list[Keyframe],
    num_frames: int,
    loop: bool = False,
    tension: float = 0.0,
):
    """Smooth camera path through the keyframes (render_panel.py:158-178).

    Returns (w2cs (N, 4, 4), fovs (N,), times (N,) | None), float32 CPU
    tensors. Frames go to segments in proportion to chord length; each
    segment gets at least one. times is None unless every keyframe has a
    time.
    """
    K = len(keyframes)
    if K == 0:
        raise ValueError("need at least one keyframe")
    f32 = torch.float32
    if K == 1 or num_frames <= 1:
        kf = keyframes[0]
        w2c = torch.linalg.inv(torch.as_tensor(np.asarray(kf.c2w), dtype=f32))
        n = max(num_frames, 1)
        fovs = torch.full((n,), kf.fov, dtype=f32)
        times = None if kf.time is None else torch.full((n,), kf.time,
                                                        dtype=f32)
        return w2c.expand(n, 4, 4), fovs, times

    c2ws = torch.as_tensor(np.stack([k.c2w for k in keyframes]), dtype=f32)
    pos = c2ws[:, :3, 3]  # (K, 3)
    qs = _align_quats(lie.rmat_to_quat(c2ws[:, :3, :3]))
    fov = torch.tensor([k.fov for k in keyframes], dtype=f32)
    have_time = all(k.time is not None for k in keyframes)
    tval = (torch.tensor([k.time or 0.0 for k in keyframes], dtype=f32)
            if have_time else None)

    m_pos = _kb_tangents(pos, loop, tension)
    m_fov = _kb_tangents(fov, loop, tension)
    m_t = _kb_tangents(tval, loop, tension) if have_time else None
    s_q = _squad_inner(qs, loop, tension)

    nseg = K if loop else K - 1
    # every segment gets >= 1 frame, so fewer frames than segments can
    # never be honored
    alloc = _frames_per_segment(pos, nseg, max(num_frames, nseg))

    w2cs, fovs, times = [], [], []
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=f32)
    for seg in range(nseg):
        j0, j1 = seg, (seg + 1) % K
        n = int(alloc[seg])
        # cover [0, 1) per segment; the last segment of a clamped path
        # includes u = 1 so the last keyframe is hit exactly
        last = (not loop) and seg == nseg - 1
        u = (torch.linspace(0.0, 1.0, n, dtype=f32) if last
             else torch.linspace(0.0, 1.0, n + 1, dtype=f32)[:-1])
        u1 = u[:, None]
        p = _hermite(pos[j0], pos[j1], m_pos[seg], m_pos[j1], u1)
        f = _hermite(fov[j0], fov[j1], m_fov[seg], m_fov[j1], u1)[:, 0]
        # squad(q0, q1, s0, s1; u) = slerp(slerp(q0, q1, u),
        # slerp(s0, s1, u), 2u(1-u)): interpolating, C1 across keyframes
        qa = _slerp(qs[j0], qs[j1], u1)
        qb = _slerp(s_q[j0], s_q[j1], u1)
        q = _slerp(qa, qb, 2.0 * u1 * (1.0 - u1))
        R = lie.quat_to_rmat(q)
        c2w = torch.cat([torch.cat([R, p[:, :, None]], dim=-1),
                         bottom.expand(n, 1, 4)], dim=1)
        w2cs.append(torch.linalg.inv(c2w))
        fovs.append(f)
        if have_time:
            times.append(_hermite(tval[j0], tval[j1], m_t[seg], m_t[j1],
                                  u1)[:, 0])
    return (torch.cat(w2cs, dim=0), torch.cat(fovs, dim=0),
            torch.cat(times, dim=0) if have_time else None)


def render_camera_path(
    render_fn,
    keyframes: list[Keyframe],
    img_wh: tuple[int, int],
    num_frames: int,
    out_path: str | None = None,
    fps: float = 30.0,
    loop: bool = False,
    tension: float = 0.0,
    num_scene_frames: int | None = None,
):
    """Render a keyframed path to frames (and optionally a video).

    render_fn: (CameraState, img_wh, t | None) -> (H, W, 3) uint8, the
    callback the interactive viewer drives (vis/renderer.py). Keyframe
    times are rounded to scene frame indices and clamped to
    [0, num_scene_frames). Returns (frames (N, H, W, 3) uint8, the video's
    path (an animated PNG, vis/utils.py::save_video) or None).
    """
    from deblur4dgs_tpu_torch.vis.renderer import CameraState

    w2cs, fovs, times = interpolate_camera_path(
        keyframes, num_frames, loop=loop, tension=tension)
    c2ws = torch.linalg.inv(w2cs).numpy()
    fovs = fovs.numpy()
    tarr = None if times is None else times.numpy()
    frames = []
    for i in range(c2ws.shape[0]):
        t = None
        if tarr is not None:
            t = int(round(float(tarr[i])))
            if num_scene_frames is not None:
                t = min(max(t, 0), num_scene_frames - 1)
        cam = CameraState(fov=float(fovs[i]), aspect=img_wh[0] / img_wh[1],
                          c2w=c2ws[i])
        frames.append(np.asarray(render_fn(cam, img_wh, t)))
    frames = np.stack(frames)
    video = None
    if out_path is not None:
        from deblur4dgs_tpu_torch.vis.utils import save_video

        video = save_video(out_path, frames, fps=fps)
    return frames, video
