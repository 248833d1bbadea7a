"""Port vs reference: HDBSCAN clustering of track velocity directions.

The reference's train/init.py::sample_initial_bases_centers(mode=
"hdbscan") runs scikit-learn's HDBSCAN(min_cluster_size=20,
max_cluster_size=max(N // 4, 21)); the port's runs train/hdbscan.py. Both
take the same numpy tracks, whose velocity directions form blobs plus
uniform noise (N 200 to 1500 tracks, d = 3 (T - 1) from 3 to 21), and
tests/test_torch_init.py::tracks_np's tracks. One draw makes
max_cluster_size bind, one holds every track twice (ties in every
distance). Bars: labels and centres exactly equal, and every stage of the
port (core distances, Prim's tree, the single-linkage tree, the condensed
tree) equal to scikit-learn's own functions, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import HDBSCAN
from sklearn.cluster._hdbscan._linkage import mst_from_data_matrix
from sklearn.cluster._hdbscan._tree import _condense_tree
from sklearn.cluster._hdbscan.hdbscan import _process_mst
from sklearn.metrics import DistanceMetric
from sklearn.neighbors import NearestNeighbors

from deblur4dgs_tpu.data.observations import TrackObservations as JTracks
from deblur4dgs_tpu.train import init as ji
from deblur4dgs_tpu_torch.data.observations import TrackObservations
from deblur4dgs_tpu_torch.train import hdbscan as H
from deblur4dgs_tpu_torch.train import init as ti
from tests.test_torch_init import tracks_np
from tests.test_torch_models import torch_single_thread  # noqa: F401


def blob_tracks(seed, n, frames, k, noise=0.2, spread=0.25, dup=False,
                hide=0.0):
    """Track arrays (xyz, visibles, invisibles, confidences, colors) whose
    per-frame
    velocities point along one of k directions, a share ``noise`` of them
    anywhere; ``dup`` repeats the first half; ``hide`` occludes samples."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(k, frames - 1, 3))
    lab = rng.integers(0, k, n)
    vel = dirs[lab] + spread * rng.normal(size=(n, frames - 1, 3))
    wild = rng.uniform(size=n) < noise
    vel[wild] = rng.normal(size=(int(wild.sum()), frames - 1, 3))
    vel *= rng.uniform(0.05, 0.2, (n, 1, 1))
    xyz = np.concatenate([rng.normal(size=(n, 1, 3)), vel], 1).cumsum(1)
    if dup:
        xyz[n // 2 :] = xyz[: n - n // 2]
    vis = rng.uniform(size=(n, frames)) >= hide
    vis[:, 0] = True
    conf = rng.uniform(0.5, 1.0, (n, frames))
    colors = rng.uniform(0, 1, (n, 3))
    return [xyz.astype(np.float32), vis, ~vis, conf.astype(np.float32),
            colors.astype(np.float32)]


DRAWS = {
    "d3": lambda: blob_tracks(0, 200, 2, 5, spread=0.1),
    "d9": lambda: blob_tracks(1, 600, 4, 5, hide=0.1),
    "d21": lambda: blob_tracks(2, 1500, 8, 8),
    "max_size_binds": lambda: blob_tracks(3, 1000, 4, 3, noise=0.1,
                                          spread=0.5),
    "duplicates": lambda: blob_tracks(4, 400, 5, 4, dup=True),
    "init_tracks": lambda: tracks_np(1, occlude=True),
}


def _vel_dirs(arrs):
    xyz = ti.interp_masked(arrs[0], arrs[1])
    vel = xyz[:, 1:] - xyz[:, :-1]
    return (vel / (np.linalg.norm(vel, axis=-1, keepdims=True) + 1e-5)
            ).reshape(len(xyz), -1)


@pytest.mark.parametrize("name", list(DRAWS))
def test_centers_and_labels_equal_the_reference(name):
    arrs = DRAWS[name]()
    n = len(arrs[0])
    jc, jl = ji.sample_initial_bases_centers(
        1, JTracks(*map(jnp.asarray, arrs)), 3, mode="hdbscan")
    tc, tl = ti.sample_initial_bases_centers(
        1, TrackObservations(*map(torch.as_tensor, arrs)), 3,
        mode="hdbscan", device="cpu")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    x = _vel_dirs(arrs)
    sk = HDBSCAN(min_cluster_size=20, max_cluster_size=max(n // 4, 21))
    want = sk.fit(x).labels_
    np.testing.assert_array_equal(
        H.hdbscan_labels(x, 20, max(n // 4, 21), device="cpu"), want)
    if name == "max_size_binds":
        free = HDBSCAN(min_cluster_size=20).fit(x).labels_
        assert free.max() < want.max()  # the cap splits a large cluster
    if name != "init_tracks":
        assert want.max() >= 1 and (want == -1).any()


@pytest.mark.parametrize("name", ["d9", "duplicates"])
def test_every_stage_equals_sklearn(name):
    x = _vel_dirs(DRAWS[name]()).astype(np.float64)
    k = 20
    mr = H.mutual_reachability(torch.as_tensor(x), k)
    dist, _ = NearestNeighbors(n_neighbors=k, algorithm="kd_tree").fit(
        x).kneighbors(x, k)  # HDBSCAN's core distances
    core = dist[:, -1]
    np.testing.assert_array_equal(torch.diagonal(mr).numpy(), core)
    metric = DistanceMetric.get_metric("euclidean")
    want = mst_from_data_matrix(x, np.ascontiguousarray(core), metric, 1.0)
    got = H.prim_mst(mr)
    for field in want.dtype.names:
        np.testing.assert_array_equal(got[field], want[field])
    hier = _process_mst(want)
    got_hier = H.single_linkage(got)
    for i, field in enumerate(hier.dtype.names):
        np.testing.assert_array_equal(got_hier[:, i], hier[field])
    cond = _condense_tree(hier, 20)
    for got_col, field in zip(H.condense_tree(got_hier, 20), cond.dtype.names):
        np.testing.assert_array_equal(got_col, cond[field])


def test_checks():
    x = np.zeros((10, 3))
    with pytest.raises(ValueError, match="min_samples"):
        H.hdbscan_labels(x, 20, device="cpu")
    x[0, 0] = np.nan
    with pytest.raises(ValueError, match="finite"):
        H.hdbscan_labels(x, 5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            H.hdbscan_labels(np.zeros((30, 3)), 5)
