"""Data-layer helpers: coordinate normalization, TAPIR track-info parsing,
track unprojection, depth -> points -> normals, masked median blur.

PyTorch port of deblur4dgs_tpu/data/utils.py. They run once at dataset
load time on the host; numpy inputs are accepted and the results are
tensors (masked_median_blur stays numpy + scipy).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    x = torch.as_tensor(x)
    return x if not x.is_floating_point() else x.to(torch.float32)


def normalize_coords(coords, h, w):
    """Pixel coords -> [-1, 1] grid coords."""
    coords = _t(coords)
    assert coords.shape[-1] == 2
    return coords / coords.new_tensor([w - 1.0, h - 1.0]) * 2.0 - 1.0


def parse_tapir_track_info(occlusions, expected_dist):
    """TAPIR occlusion / uncertainty logits -> visible / invisible /
    confidence masks."""
    visibility = 1.0 - torch.sigmoid(_t(occlusions))
    confidence = 1.0 - torch.sigmoid(_t(expected_dist))
    valid_visible = visibility * confidence > 0.5
    valid_invisible = (1.0 - visibility) * confidence > 0.5
    confidence = confidence * (valid_visible | valid_invisible)
    return valid_visible, valid_invisible, confidence


def bilinear_sample(img, xy):
    """Sample (H, W) or (H, W, C) at float pixel coords (N, 2) with border
    padding (grid_sample align_corners=True on pixel coords)."""
    img, xy = _t(img), _t(xy)
    H, W = img.shape[:2]
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    x = torch.clamp(xy[:, 0], 0.0, W - 1.0)
    y = torch.clamp(xy[:, 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )
    return out[..., 0] if squeeze else out


def get_tracks_3d_for_query_frame(
    query_index: int,
    query_img,  # (H, W, 3)
    tracks_2d,  # (N, T, 4): xy + occlusion + expected_dist
    depths,  # (T, H, W)
    masks,  # (T, H, W)
    inv_Ks,  # (T, 3, 3)
    c2ws,  # (T, 4, 4)
):
    """Unproject TAPIR 2D tracks to 3D.

    Returns (tracks_3d (N, T, 3), colors (N, 3), visibles, invisibles,
    confidences (N, T))."""
    depths, inv_Ks, c2ws = _t(depths), _t(inv_Ks), _t(c2ws)
    t2d = _t(tracks_2d).transpose(0, 1)  # (T, N, 4)
    xy, occs, dists = t2d[..., :2], t2d[..., 2], t2d[..., 3]
    visibles, invisibles, confidences = parse_tapir_track_info(occs, dists)

    track_depths = torch.stack([bilinear_sample(d, p)
                                for d, p in zip(depths, xy)])  # (T, N)
    xy_h = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    pts_cam = torch.einsum("tij,tnj->tni", inv_Ks, xy_h) * \
        track_depths[..., None]
    pts_h = torch.cat([pts_cam, torch.ones_like(pts_cam[..., :1])], -1)
    tracks_3d = torch.einsum("tij,tnj->tni", c2ws, pts_h)[..., :3]

    colors = bilinear_sample(query_img, xy[query_index])  # (N, 3)
    return (
        tracks_3d.transpose(0, 1),
        colors,
        visibles.transpose(0, 1),
        invisibles.transpose(0, 1),
        confidences.transpose(0, 1),
    )


def depth_to_points_world(depth, K, w2c):
    """(H, W) depth -> (H, W, 3) world points."""
    depth, K, w2c = _t(depth), _t(K), _t(w2c)
    H, W = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij",
    )
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)  # (H, W, 3)
    cam = torch.einsum("ij,hwj->hwi", torch.linalg.inv(K), pix) * \
        depth[..., None]
    c2w = torch.linalg.inv(w2c)
    return torch.einsum("ij,hwj->hwi", c2w[:3, :3], cam) + c2w[:3, 3]


def normal_from_depth_image(depth, K, w2c):
    """(H, W) depth -> (H, W, 3) world-space normals via central
    differences of the unprojected point cloud."""
    xyz = depth_to_points_world(depth, K, w2c)
    top = xyz[:-2, 1:-1]
    bottom = xyz[2:, 1:-1]
    left = xyz[1:-1, :-2]
    right = xyz[1:-1, 2:]
    n = torch.linalg.cross(right - left, top - bottom)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-8)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def masked_median_blur(imgs: np.ndarray, masks: np.ndarray, ksize: int = 11):
    """Median filter applied only where masked, for depth cleanup.
    imgs: (T, H, W); masks: (T, H, W)."""
    import scipy.ndimage as ndi

    out = imgs.copy()
    for i in range(imgs.shape[0]):
        med = ndi.median_filter(imgs[i], size=ksize)
        m = masks[i] > 0.5
        out[i][m] = med[m]
    return out
