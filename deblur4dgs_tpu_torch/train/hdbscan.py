"""HDBSCAN labels, computed as scikit-learn 1.9.0 computes them.

No counterpart module in the JAX package: its train/init.py::
sample_initial_bases_centers(mode="hdbscan") calls
``sklearn.cluster.HDBSCAN(min_cluster_size=20, max_cluster_size=...)``,
and the port does not use scikit-learn. ``hdbscan_labels`` returns that
estimator's ``labels_`` with every other setting at its default (Euclidean
metric, ``min_samples = min_cluster_size``, ``alpha = 1``, "eom" selection,
``cluster_selection_epsilon = 0``, ``allow_single_cluster = False``):
the same labels, not the same up to a permutation.

* The distances run on ``device`` in torch, in float64
  (``mutual_reachability``, ``prim_mst``). Each one is the square root of
  squared differences summed feature by feature in index order, as
  sklearn's ``EuclideanDistance`` sums them, so the card and the CPU give
  sklearn's bits. A point's core distance is the distance to its
  ``min_samples``-th nearest point, itself included (sklearn's k-d tree
  query); Prim's algorithm runs over the mutual-reachability graph with
  ``_linkage.pyx::mst_from_data_matrix``'s tie-breaking (the first node of
  least reachability). The whole (N, N) matrix is kept on ``device``:
  8 N^2 bytes, 12.8 GB at N = 40k.
* The tree runs on the host in numpy, a transcription of sklearn's
  ``hdbscan.py::_process_mst`` (its ``np.argsort``), ``_linkage.pyx::
  make_single_linkage`` and ``_tree.pyx``'s ``_condense_tree``,
  ``_compute_stability``, ``_get_clusters`` and ``_do_labelling``.
"""

from __future__ import annotations

import numpy as np
import torch

from deblur4dgs_tpu_torch import resolve_device

NOISE = -1
# sklearn's MST_edge_dtype (_linkage.pyx): argsort runs on this layout
MST_EDGE = np.dtype([("current_node", np.int64), ("next_node", np.int64),
                     ("distance", np.float64)])
BLOCK_BYTES = 1 << 29  # one (rows, N) float64 block of the distance pass


def _sqrt_(t: torch.Tensor):
    """Square root in place, correctly rounded like the C library's sqrt
    that sklearn calls. torch's vectorised float64 sqrt on the CPU can be
    1 ulp off; numpy's is the rounded instruction. CUDA's float64 sqrt is
    IEEE-rounded."""
    if t.device.type == "cpu":
        a = t.numpy()
        np.sqrt(a, out=a)
    else:
        t.sqrt_()


def mutual_reachability(x: torch.Tensor, min_samples: int) -> torch.Tensor:
    """The (N, N) mutual-reachability distances max(d(i, j), core(i),
    core(j)) of float64 points (N, d), on their device."""
    n, d = x.shape
    xt = x.T.contiguous()
    out = torch.empty((n, n), dtype=torch.float64, device=x.device)
    block = max(1, min(n, BLOCK_BYTES // (8 * n)))
    tmp = torch.empty((block, n), dtype=torch.float64, device=x.device)
    core = torch.empty(n, dtype=torch.float64, device=x.device)
    for i0 in range(0, n, block):
        rows, t = out[i0 : i0 + block], tmp[: min(block, n - i0)]
        rows.zero_()
        for j in range(d):  # in feature order: sklearn's summation
            torch.sub(x[i0 : i0 + block, j, None], xt[j][None], out=t)
            t.mul_(t)
            rows.add_(t)
        _sqrt_(rows)
        core[i0 : i0 + block] = rows.kthvalue(min_samples, dim=1).values
    for i0 in range(0, n, block):
        rows = out[i0 : i0 + block]
        torch.maximum(rows, core[i0 : i0 + block, None], out=rows)
        torch.maximum(rows, core[None], out=rows)
    return out


def prim_mst(mr: torch.Tensor) -> np.ndarray:
    """Prim's minimum spanning tree of a dense mutual-reachability matrix
    as sklearn's ``mst_from_data_matrix`` builds it: edges in the order
    they join, each (source, new node, distance), starting from node 0;
    the new node is the first of least reachability. Runs on ``mr``'s
    device with one transfer at the end."""
    n, dev = mr.shape[0], mr.device
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    reach = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    source = torch.ones(n, dtype=torch.int64, device=dev)
    cur = torch.zeros(1, dtype=torch.int64, device=dev)
    src = torch.empty(n - 1, dtype=torch.int64, device=dev)
    dst = torch.empty(n - 1, dtype=torch.int64, device=dev)
    dist = torch.empty(n - 1, dtype=torch.float64, device=dev)
    for i in range(n - 1):
        in_tree.index_fill_(0, cur, True)
        row = mr.index_select(0, cur)[0]
        closer = row < reach
        reach = torch.where(closer, row, reach)
        source = torch.where(closer, cur, source)
        cand = reach.masked_fill(in_tree, float("inf"))
        cur = torch.argmin(cand, dim=0, keepdim=True)  # the first least
        src[i : i + 1] = source.index_select(0, cur)
        dst[i : i + 1] = cur
        dist[i : i + 1] = cand.index_select(0, cur)
    mst = np.empty(n - 1, dtype=MST_EDGE)
    mst["current_node"] = src.cpu().numpy()
    mst["next_node"] = dst.cpu().numpy()
    mst["distance"] = dist.cpu().numpy()
    return mst


def single_linkage(mst: np.ndarray) -> np.ndarray:
    """``_process_mst``: edges sorted by distance (sklearn's own
    ``np.argsort``, whose order among ties the tree inherits), then merged
    with a union-find. Rows (left, right, distance, size) as (N-1, 4)
    float64; a merged cluster is numbered N + its row."""
    mst = mst[np.argsort(mst["distance"])]
    n = len(mst) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    out = np.zeros((n - 1, 4), np.float64)

    def find(a):
        root = a
        while parent[root] != -1:
            root = parent[root]
        while a != root and parent[a] != root:  # path compression
            parent[a], a = root, parent[a]
        return root

    for i, (a, b, d) in enumerate(mst.tolist()):
        a, b = find(a), find(b)
        out[i] = a, b, d, size[a] + size[b]
        parent[a] = parent[b] = n + i
        size[n + i] = size[a] + size[b]
    return out


def _bfs(left, right, n, root) -> list[int]:
    """``bfs_from_hierarchy``: node ids level by level, left before right."""
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        queue = [c for q in queue if q >= n
                 for c in (left[q - n], right[q - n])]
    return out


def condense_tree(hier: np.ndarray, min_cluster_size: int):
    """``_condense_tree``: rows (parent, child, lambda, child size) as four
    arrays, in sklearn's order."""
    n = hier.shape[0] + 1
    root = 2 * hier.shape[0]
    left = hier[:, 0].astype(np.int64).tolist()
    right = hier[:, 1].astype(np.int64).tolist()
    dist, sizes = hier[:, 2].tolist(), hier[:, 3].astype(np.int64).tolist()
    next_label = n + 1
    relabel = [0] * (root + 1)
    relabel[root] = n
    ignore = [False] * (root + 1)
    rows = []

    def count(node):
        return sizes[node - n] if node >= n else 1

    def drop(par, lam, sub):  # every point under ``sub`` falls off ``par``
        for s in _bfs(left, right, n, sub):
            if s < n:
                rows.append((par, s, lam, 1))
            ignore[s] = True

    for node in _bfs(left, right, n, root):
        if ignore[node] or node < n:
            continue
        l, r, d = left[node - n], right[node - n], dist[node - n]
        lam = 1.0 / d if d > 0.0 else float("inf")
        lc, rc = count(l), count(r)
        par = relabel[node]
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[l] = next_label
            rows.append((par, next_label, lam, lc))
            relabel[r] = next_label + 1
            rows.append((par, next_label + 1, lam, rc))
            next_label += 2
        elif lc < min_cluster_size and rc < min_cluster_size:
            drop(par, lam, l)
            drop(par, lam, r)
        elif lc < min_cluster_size:
            relabel[r] = par
            drop(par, lam, l)
        else:
            relabel[l] = par
            drop(par, lam, r)
    par, child, lam, size = zip(*rows)
    return (np.array(par, np.int64), np.array(child, np.int64),
            np.array(lam, np.float64), np.array(size, np.int64))


def compute_stability(tree) -> dict:
    """``_compute_stability``: each cluster's sum of (lambda - its birth
    lambda) * size over its rows, accumulated in row order."""
    par, child, lam, size = tree
    smallest = int(par.min())
    births = np.full(max(int(child.max()), smallest) + 1, np.nan)
    births[child] = lam
    births[smallest] = 0.0
    births = births.tolist()
    result = [0.0] * (int(par.max()) - smallest + 1)
    for p, v, s in zip(par.tolist(), lam.tolist(), size.tolist()):
        result[p - smallest] += (v - births[p]) * s
    return {i + smallest: r for i, r in enumerate(result)}


class _TreeUnionFind:
    """``_tree.pyx::TreeUnionFind``: union by rank, so the root of a set is
    sklearn's."""

    def __init__(self, size):
        self.parent = list(range(size))
        self.rank = [0] * size

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, x, y):
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1


def get_clusters(tree, stability: dict, max_cluster_size: int) -> np.ndarray:
    """``_get_clusters`` with "eom" selection, epsilon 0 and no single
    cluster, then ``_do_labelling``: a label per point, NOISE for none."""
    par, child, lam, size = tree
    node_list = sorted(stability.keys(), reverse=True)[:-1]
    big = size > 1
    c_par, c_child = par[big], child[big]
    is_cluster = {c: True for c in node_list}
    cluster_sizes = dict(zip(c_child.tolist(), size[big].tolist()))
    for node in node_list:
        sub = np.sum([stability[c] for c in c_child[c_par == node].tolist()])
        if sub > stability[node] or cluster_sizes[node] > max_cluster_size:
            is_cluster[node] = False
            stability[node] = sub
        else:  # every cluster below ``node`` is dropped
            queue = np.array([node])
            while queue.size:
                for s in queue.tolist():
                    if s != node:
                        is_cluster[s] = False
                queue = c_child[np.isin(c_par, queue)]
    clusters = {c for c in is_cluster if is_cluster[c]}
    label_of = {c: i for i, c in enumerate(sorted(clusters))}

    root = int(par.min())
    uf = _TreeUnionFind(int(par.max()) + 1)
    for p, c in zip(par.tolist(), child.tolist()):
        if c not in clusters:
            uf.union(p, c)
    labels = np.empty(root, np.int64)
    for i in range(root):
        c = uf.find(i)
        labels[i] = NOISE if c == root else label_of[c]
    return labels


def hdbscan_labels(x, min_cluster_size: int = 20,
                   max_cluster_size: int | None = None,
                   device="cuda") -> np.ndarray:
    """sklearn 1.9.0's ``HDBSCAN(min_cluster_size=, max_cluster_size=)
    .fit(x).labels_`` for finite points (N, d): int64 labels, -1 for
    noise. The distances run on ``device``, the tree on the host."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if x.ndim != 2 or n < 2:
        raise ValueError(f"hdbscan_labels takes points (N >= 2, d), got "
                         f"shape {x.shape}")
    if not np.isfinite(x).all():
        raise ValueError("hdbscan_labels takes finite points")
    k = min_cluster_size  # sklearn's min_samples=None
    if k > n:
        raise ValueError(f"min_samples ({k}) must be at most the number of "
                         f"samples in X ({n})")
    if max_cluster_size is None:
        max_cluster_size = n + 1  # never binds
    dev = resolve_device(device)
    mr = mutual_reachability(torch.as_tensor(x, device=dev), k)
    mst = prim_mst(mr)
    del mr
    tree = condense_tree(single_linkage(mst), min_cluster_size)
    return get_clusters(tree, compute_stability(tree), max_cluster_size)
