"""Scene bootstrap from 3D tracks and static points.

PyTorch port of deblur4dgs_tpu/train/init.py (the reference's
flow3d/init_utils.py). Host-side preprocessing stays numpy, as in the JAX
package, with its own copies of the helpers (no scikit-learn: the k-nearest
neighbours come from scipy's cKDTree); the Procrustes fits and the initial
optimization run on the caller's device:

  * fg Gaussians from canonical-frame track positions (knn-mean scales,
    logit colors/opacities);
  * bg Gaussians from static points with normal-aligned quats;
  * motion bases: outlier-filtered tracks, velocity-direction k-means
    clustering, per-cluster per-frame weighted Procrustes SE(3) fits;
  * ``run_initial_optim``: Adam pre-optimization of bases + coefs + means
    against 3D/2D track losses, step for step the reference's optax chain
    (scale_by_adam, per-group scales, scale_by_schedule), as a plain loop
    (the reference scans it in one jitted program).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.data.observations import (
    StaticObservations,
    TrackObservations,
)
from deblur4dgs_tpu_torch.models.gaussians import Gaussians
from deblur4dgs_tpu_torch.models.motion_bases import (
    MotionBases,
    compute_transforms,
)
from deblur4dgs_tpu_torch.ops import lie
from deblur4dgs_tpu_torch.train import losses as L

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam defaults


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _logit(x):
    x = np.clip(x, 1e-6, 1 - 1e-6)
    return np.log(x) - np.log1p(-x)


def round_capacity(n: int) -> int:
    """A Gaussian buffer's capacity: n rounded up to a multiple of 256
    (deblur4dgs_tpu/pipeline.py::_round_capacity)."""
    return max(int(-(-n // 256)) * 256, 256)


def knn_dists(x: np.ndarray, k: int) -> np.ndarray:
    """Distances to the k nearest neighbours (excluding self), (N, k)."""
    x = np.asarray(x, np.float64)
    d, _ = cKDTree(x).query(x, k=k + 1)
    return d[:, 1:].astype(np.float32)


def init_fg_from_tracks_3d(
    cano_t: int, tracks_3d: TrackObservations, motion_coefs, seed: int = 0,
    device="cuda",
) -> Gaussians:
    """init_utils.py:32-62 semantics; the Gaussians on ``device``."""
    dev = resolve_device(device)
    xyz = _np(tracks_3d.xyz)
    num_fg = xyz.shape[0]
    colors = _logit(_np(tracks_3d.colors))
    d = knn_dists(xyz[:, cano_t], 3).mean(axis=-1, keepdims=True)
    lo, hi = np.quantile(d, 0.05), np.quantile(d, 0.95)
    scales = np.log(np.clip(d, lo, hi)).repeat(3, axis=-1)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return Gaussians(
        means=t(xyz[:, cano_t]),
        quats=t(rng.uniform(size=(num_fg, 4))),
        scales=t(scales),
        colors=t(colors),
        opacities=torch.full((num_fg,), float(_logit(0.7)), device=dev),
        motion_coefs=t(_np(motion_coefs)),
    )


def init_bg(points: StaticObservations, device="cuda"):
    """init_utils.py:65-111: static points with normal-aligned quats.
    Returns (Gaussians on ``device``, bg_scene_scale)."""
    dev = resolve_device(device)
    xyz = _np(points.xyz)
    n = xyz.shape[0]
    centered = xyz - xyz.mean(0)
    scene_scale = float(
        np.max(np.quantile(centered, 0.95, axis=0)
               - np.quantile(centered, 0.05, axis=0)) / 2.0
    )
    colors = _logit(_np(points.colors))
    d = knn_dists(xyz, 3).mean(axis=-1, keepdims=True)
    scales = np.log(np.maximum(d, 1e-6)).repeat(3, axis=-1)

    # quats rotating +z to the point normal (init_utils.py:92-98)
    normals = _np(points.normals)
    normals = normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-8)
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(np.broadcast_to(z, normals.shape), normals)
    axis = axis / np.maximum(np.linalg.norm(axis, axis=-1, keepdims=True),
                             1e-8)
    ang = np.arccos(np.clip((normals * z).sum(-1, keepdims=True), -1, 1))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    quats = lie.quat_exp(t(axis * ang))
    return (
        Gaussians(
            means=t(xyz), quats=quats, scales=t(scales), colors=t(colors),
            opacities=torch.full((n,), float(_logit(0.7)), device=dev),
        ),
        scene_scale,
    )


def interp_masked(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Linearly interpolate masked-out (occluded) track samples over time.

    vals (G, T, 3), mask (G, T) bool (init_utils.py:594-654). Rows seen at
    every frame are returned as they are (np.interp at its own knots)."""
    G, T = mask.shape
    out = vals.copy()
    t = np.arange(T)
    mask = mask.astype(bool)
    partial = np.nonzero(~mask.all(1) & mask.any(1))[0]
    for g in partial:
        m = mask[g]
        for c in range(vals.shape[-1]):
            out[g, :, c] = np.interp(t, t[m], vals[g, m, c])
    return out


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    """Plain numpy k-means labels (replaces cuml KMeans)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(x.shape[0], size=k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        labels = d.argmin(1)
        for j in range(k):
            sel = labels == j
            if sel.any():
                centers[j] = x[sel].mean(0)
    return labels


def sample_initial_bases_centers(
    cano_t: int, tracks_3d: TrackObservations, num_bases: int, seed: int = 0,
    mode: str = "kmeans",
):
    """init_utils.py:534-592: cluster velocity directions; centres are the
    per-cluster median canonical positions. Returns (centers, labels) as
    numpy. Only ``mode="kmeans"``: the reference's "hdbscan" needs
    scikit-learn, which the port does not use."""
    if mode != "kmeans":
        raise NotImplementedError(
            f"mode={mode!r}: the port clusters with k-means only (the "
            "reference's 'hdbscan' mode uses scikit-learn's HDBSCAN)"
        )
    xyz = _np(tracks_3d.xyz)
    xyz_interp = interp_masked(xyz, _np(tracks_3d.visibles))
    vel = xyz_interp[:, 1:] - xyz_interp[:, :-1]
    vel_dirs = (vel / (np.linalg.norm(vel, axis=-1, keepdims=True) + 1e-5)
                ).reshape(xyz.shape[0], -1)
    labels = kmeans(vel_dirs, num_bases, seed=seed)
    centers = np.stack(
        [np.median(xyz[labels == i, cano_t], axis=0) for i in range(num_bases)]
    )
    return centers, labels


def get_weights_for_procrustes(cluster: np.ndarray, visibilities: np.ndarray):
    """loss_utils.py:102-115. cluster (T, P, 3); visibilities (T, P)."""
    med = np.median(cluster, axis=-2, keepdims=True)
    d = np.linalg.norm(cluster - med, axis=-1)
    d = d / (np.median(d, axis=-1, keepdims=True) + 1e-12)
    w = np.exp(-d)
    w = w / (w.mean(axis=-1, keepdims=True) + 1e-6)
    w = w * (visibilities.astype(np.float32) + 1e-6)
    invalid = d > np.quantile(d, 0.9)
    invalid |= np.isnan(w)
    w[invalid] = 0
    return w


def init_motion_params_with_procrustes(
    tracks_3d: TrackObservations,
    num_bases: int,
    cano_t: int,
    min_mean_weight: float = 0.1,
    seed: int = 0,
    device="cuda",
):
    """init_utils.py:114-270: outlier filter, clustering, per-frame weighted
    Procrustes SE(3) fits on ``device`` (6D rotation output).

    Returns (MotionBases, motion_coefs (G', K) pre-softmax, the filtered
    TrackObservations), all on ``device``."""
    dev = resolve_device(device)
    arrs = [_np(x) for x in tracks_3d]
    xyz = arrs[0]
    num_frames = xyz.shape[1]
    means_cano = xyz[:, cano_t]

    center = np.median(means_cano, axis=0)
    dists = np.linalg.norm(means_cano - center, axis=-1)
    valid = dists < np.quantile(dists, 0.95)
    valid &= arrs[1].any(axis=1)
    tracks_np = TrackObservations(*[a[valid] for a in arrs])
    means_cano = means_cano[valid]

    centers, labels = sample_initial_bases_centers(
        cano_t, tracks_np, num_bases, seed=seed
    )
    d2c = np.linalg.norm(means_cano[:, None] - centers[None], axis=-1)
    motion_coefs = 10 * np.exp(-d2c)  # (G, K) pre-softmax

    id_rot = np.array([1.0, 0, 0, 0, 1, 0], np.float32)
    init_rots = np.tile(id_rot, (num_bases, num_frames, 1))
    init_ts = np.zeros((num_bases, num_frames, 3), np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    tgt_ts = list(range(cano_t - 1, -1, -1)) + list(range(cano_t, num_frames))
    for n in range(num_bases):
        sel = labels == n
        cluster = tracks_np.xyz[sel].swapaxes(0, 1)  # (T, P, 3)
        vis = tracks_np.visibles[sel].swapaxes(0, 1)
        conf = tracks_np.confidences[sel].swapaxes(0, 1)
        weights = get_weights_for_procrustes(cluster, vis)
        prev_t = cano_t
        for cur_t in tgt_ts:
            w = weights[cano_t] * weights[cur_t] * (
                conf[cano_t] + conf[cur_t]) / 2
            if w.sum() < min_mean_weight * num_frames:
                init_rots[n, cur_t] = init_rots[n, prev_t]
                init_ts[n, cur_t] = init_ts[n, prev_t]
            else:
                (q, tr, _), _ = lie.solve_procrustes(
                    t(cluster[cano_t]), t(cluster[cur_t]), t(w),
                    enforce_se3=True)
                init_rots[n, cur_t] = _np(lie.rmat_to_cont_6d(
                    lie.quat_to_rmat(q)))
                init_ts[n, cur_t] = _np(tr)
            prev_t = cur_t

    bases = MotionBases(rots=t(init_rots), transls=t(init_ts))
    tracks_out = TrackObservations(*(torch.as_tensor(a, device=dev)
                                     for a in tracks_np))
    return bases, t(motion_coefs), tracks_out


# ---------------------------------------------------------------------------
# Initial optimization (init_utils.py:273-443)
# ---------------------------------------------------------------------------


class _Bases(NamedTuple):
    """MotionBases' fields as plain tensors (compute_transforms' input)."""

    rots: torch.Tensor
    transls: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.rots.shape[1]


def project_2d_tracks(xyz, Ks, w2cs):
    """xyz (G, T, 3) world; Ks (T, 3, 3), w2cs (T, 4, 4) -> uv (G, T, 2),
    depth (G, T)."""
    cam = torch.einsum("tij,gtj->gti", w2cs[:, :3, :3], xyz) \
        + w2cs[None, :, :3, 3]
    uvz = torch.einsum("tij,gtj->gti", Ks, cam)
    depth = torch.clamp(uvz[..., 2], min=1e-6)
    return uvz[..., :2] / depth[..., None], depth


# run_initial_optim's per-group step sizes (the masked optax.scale chain)
INIT_LRS = {"rots": 1e-2, "transls": 3e-2, "coefs": 1e-2, "means": 1e-3}


def run_initial_optim(
    fg: Gaussians,
    bases: MotionBases,
    tracks_3d: TrackObservations,
    Ks,
    w2cs,
    num_iters: int = 1000,
    device="cuda",
):
    """Adam pre-optimization of (bases, coefs, means) against the track
    losses, ``num_iters`` steps on ``device``.

    Each step follows the reference's optax chain: scale_by_adam (b1 0.9,
    b2 0.999, eps 1e-8, bias correction at the incremented count), the
    per-group -lr of INIT_LRS, then scale_by_schedule(0.1 ** (count /
    num_iters)) at the schedule's pre-increment count. The smoothness
    weight ramps from 0.01 to 0.1 after iteration 400. Returns (fg with new
    means and motion_coefs, new MotionBases, losses (num_iters,))."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    Ks = torch.as_tensor(Ks, **f32)
    w2cs = torch.as_tensor(w2cs, **f32)
    tracks = TrackObservations(*(torch.as_tensor(x, device=dev)
                                 for x in tracks_3d))
    num_frames = bases.num_frames
    ts = torch.arange(num_frames, **f32)
    tsc = torch.clamp(ts, 1, num_frames - 2)
    ts_nb = torch.cat([tsc - 1, tsc, tsc + 1])

    gt_2d, _ = project_2d_tracks(tracks.xyz, Ks, w2cs)
    vis_conf = tracks.visibles.to(torch.float32) * tracks.confidences
    invis_conf = tracks.invisibles.to(torch.float32) * tracks.confidences

    params = {
        "rots": bases.rots.detach().to(dev).clone(),
        "transls": bases.transls.detach().to(dev).clone(),
        "coefs": fg.motion_coefs.detach().to(dev).clone(),
        "means": fg.means.detach().to(dev).clone(),
    }
    for p in params.values():
        p.requires_grad_(True)
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def w_smooth(i, min_v, max_v, th=400):
        return min_v if i <= th else \
            (max_v - min_v) * (i - th) / (num_iters - th) + min_v

    def loss_fn(i):
        b = _Bases(params["rots"], params["transls"])
        coefs = torch.softmax(params["coefs"], dim=-1)
        means_h = torch.cat([params["means"],
                             torch.ones_like(params["means"][:, :1])], -1)
        transfms = compute_transforms(b, ts, coefs)
        positions = torch.einsum("gtij,gj->gti", transfms, means_h)

        loss = L.masked_l1_loss(positions, tracks.xyz, mask=vis_conf)
        pred_2d, _ = project_2d_tracks(positions, Ks, w2cs)
        loss = loss + 0.5 * L.masked_l1_loss(
            pred_2d, gt_2d, mask=invis_conf, quantile=0.95) / Ks[0, 0, 0]
        loss = loss + 0.01 * (1.0 - torch.mean(torch.sum(coefs**2, dim=-1)))
        ws = w_smooth(i, 0.01, 0.1)
        loss = loss + ws * L.compute_se3_smoothness_loss(params["rots"],
                                                         params["transls"])
        loss = loss + ws * 0.5 * L.compute_accel_loss(positions)
        transfms_nb = compute_transforms(b, ts_nb, coefs)
        means_nb = torch.einsum("gtij,gj->gti", transfms_nb, means_h)
        means_nb = means_nb.reshape(means_nb.shape[0], 3, -1, 3)
        return loss + 0.1 * L.compute_z_acc_loss(means_nb, w2cs)

    losses = []
    b1, b2 = torch.tensor(B1, **f32), torch.tensor(B2, **f32)
    for i in range(num_iters):
        loss = loss_fn(i)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** float(i + 1), 1 - b2 ** float(i + 1)
            decay = torch.tensor(0.1, **f32) ** torch.tensor(i / num_iters,
                                                             **f32)
            for (k, p), g in zip(params.items(), grads):
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = (1 - B2) * (g * g) + B2 * nu[k]
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
                p.add_(u * -INIT_LRS[k] * decay)
        losses.append(loss.detach())

    out_fg = Gaussians(
        means=params["means"].detach(), quats=fg.quats.detach().to(dev),
        scales=fg.scales.detach().to(dev), colors=fg.colors.detach().to(dev),
        opacities=fg.opacities.detach().to(dev),
        motion_coefs=params["coefs"].detach(),
        alive=None if fg.alive is None else fg.alive.to(dev),
    )
    out_bases = MotionBases(params["rots"].detach(),
                            params["transls"].detach())
    return out_fg, out_bases, torch.stack(losses)
