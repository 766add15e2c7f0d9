"""Density clustering of the ablation proposers — DBSCAN and HDBSCAN with
the labels scikit-learn's `DBSCAN(eps, min_samples)` and
`HDBSCAN(min_cluster_size)` give, in numpy and scipy alone.

The reference (findnpropagate_tpu/openvocab/alt_proposers.py:35, :358)
calls sklearn when it can import it. The port imports no sklearn, so it
computes what sklearn computes:

* DBSCAN: a point's neighbours are the points within `eps` (itself
  included, distance <= eps); a point is core when it has at least
  `min_samples` of them; clusters are the connected components of the core
  points, numbered in the order of their lowest-index core point; a border
  point joins the lowest-numbered cluster holding one of its core
  neighbours (what sklearn's depth-first `dbscan_inner` assigns).
* HDBSCAN with sklearn's defaults (euclidean, `min_samples =
  min_cluster_size`, alpha 1, excess-of-mass selection, no single cluster,
  no epsilon): core distances to the min_samples-th neighbour (itself
  included), the minimum spanning tree of the mutual reachability graph by
  sklearn's Prim's order (`mst_from_data_matrix`: the remaining point of
  least reachability, the lowest index among ties), its edges sorted by
  `np.argsort` as sklearn sorts them, the single-linkage tree, the condensed
  tree, the stabilities, and the labels. Mutual reachability distances tie
  often (every edge shorter than a core distance takes that core distance),
  so which spanning tree is built decides how ties merge; hence the same
  order, and the same rounding: distances are f64 sums of squared
  differences taken feature by feature, as sklearn's distance metric sums
  them.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from .. import resolve_device


def _dist(a, b):
    """Euclidean distances between rows of a and b (broadcast), the squares
    summed feature by feature in f64."""
    d = a - b
    s = d[..., 0] * d[..., 0]
    for k in range(1, d.shape[-1]):
        s = s + d[..., k] * d[..., k]
    return np.sqrt(s)


def dbscan(points, eps, min_samples):
    """(N, F) -> (N,) int64 labels, -1 for noise."""
    x = np.asarray(points, np.float64)
    n = len(x)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    # candidate pairs from the tree, then the exact test on each
    pairs = cKDTree(x).query_pairs(eps * (1 + 1e-9) + 1e-12,
                                   output_type="ndarray")
    pairs = pairs[_dist(x[pairs[:, 0]], x[pairs[:, 1]]) <= eps]
    i, j = pairs[:, 0], pairs[:, 1]
    count = 1 + np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    core = count >= min_samples
    if not core.any():
        return labels
    cc = core[i] & core[j]
    graph = coo_matrix((np.ones(int(cc.sum())), (i[cc], j[cc])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # number the components by their lowest-index core point
    core_idx = np.flatnonzero(core)
    first = np.full(n, n, np.int64)
    np.minimum.at(first, comp[core_idx], core_idx)
    roots = np.unique(first[comp[core_idx]])
    rank = np.empty(n, np.int64)
    rank[roots] = np.arange(len(roots))
    labels[core_idx] = rank[first[comp[core_idx]]]
    # border points: the lowest cluster among their core neighbours
    border = np.full(n, n, np.int64)
    for a, b in ((i, j), (j, i)):
        sel = ~core[a] & core[b]
        np.minimum.at(border, a[sel], labels[b[sel]])
    hit = ~core & (border < n)
    labels[hit] = border[hit]
    return labels


# ---------------------------------------------------------------- HDBSCAN

def _core_distances(x, k):
    """Distance of each point to its k-th nearest point, itself included.
    The tree proposes k + 8 candidates; their exact distances decide."""
    m = min(len(x), k + 8)
    _, nb = cKDTree(x).query(x, k=m)
    nb = nb.reshape(len(x), m)
    d = np.sort(_dist(x[:, None, :], x[nb]), axis=1)
    return d[:, k - 1]


# Prim's steps per CUDA-graph replay
PRIM_GRAPH_STEPS = 256


def _prim_mst(x, core, device):
    """(source, target, distance) of the n-1 edges in the order sklearn's
    `mst_from_data_matrix` adds them, computed on `device` in f64 with no
    host sync inside the loop: per step the distances from the newest tree
    point to every point, the reachabilities lowered where the mutual
    reachability is strictly less (the source moving with them), and the
    point of least reachability, the lowest index among ties (argmin's
    first). Points in the tree have an infinite core distance, so their
    reachability stays infinite. On CUDA the steps are captured in a CUDA
    graph of PRIM_GRAPH_STEPS steps and replayed, so the host launches one
    graph where it would launch some twenty kernels a step."""
    n, f = x.shape
    xt = torch.from_numpy(x).to(device)
    core_t = torch.from_numpy(core).to(device)
    core_left = core_t.clone()
    reach = torch.full((n,), float("inf"), dtype=torch.float64,
                       device=device)
    source = torch.zeros(n, dtype=torch.int64, device=device)
    edges = torch.empty((n - 1, 2), dtype=torch.int64, device=device)
    dist = torch.empty(n - 1, dtype=torch.float64, device=device)
    cur = torch.zeros(1, dtype=torch.int64, device=device)
    e = torch.zeros(1, dtype=torch.int64, device=device)
    core_left.index_fill_(0, cur, float("inf"))

    def step():
        d = xt - xt.index_select(0, cur)
        d = d * d
        s = d[:, 0]
        for k in range(1, f):
            s = s + d[:, k]
        mrd = torch.maximum(torch.maximum(core_t.index_select(0, cur),
                                          core_left), torch.sqrt(s))
        upd = mrd < reach
        torch.where(upd, mrd, reach, out=reach)
        torch.where(upd, cur, source, out=source)
        cur.copy_(torch.argmin(reach).reshape(1))
        edges.index_copy_(0, e, torch.cat([source.index_select(0, cur),
                                           cur])[None])
        dist.index_copy_(0, e, reach.index_select(0, cur))
        # a Python value: a tensor value is read on the host (a sync)
        reach.index_fill_(0, cur, float("inf"))
        core_left.index_fill_(0, cur, float("inf"))
        e.add_(1)

    steps = n - 1
    if device.type == "cuda" and steps > 2 * PRIM_GRAPH_STEPS:
        # a few steps on a side stream before the capture, as it requires
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        steps -= 3
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(PRIM_GRAPH_STEPS):
                step()
        for _ in range(steps // PRIM_GRAPH_STEPS):
            graph.replay()
        steps %= PRIM_GRAPH_STEPS
    for _ in range(steps):
        step()
    edges = edges.cpu().numpy()
    return edges[:, 0], edges[:, 1], dist.cpu().numpy()


def _single_linkage(src, dst, dist):
    """sklearn's make_single_linkage over the sorted edges: rows (left,
    right, distance, size), new clusters numbered from n."""
    n = len(src) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    out = []
    nxt = n

    def find(v):
        p = v
        while parent[v] != -1:
            v = parent[v]
        while parent[p] != v and p != v:
            parent[p], p = v, parent[p]
        return v

    for a, b, d in zip(src.tolist(), dst.tolist(), dist.tolist()):
        ra, rb = find(a), find(b)
        out.append((ra, rb, d, int(size[ra] + size[rb])))
        parent[ra] = parent[rb] = nxt
        size[nxt] = size[ra] + size[rb]
        nxt += 1
    return out


def _bfs(tree, root, n):
    """Nodes of the single-linkage subtree under `root`, breadth first."""
    result, queue = [], [root]
    while queue:
        result.extend(queue)
        queue = [c for v in queue if v >= n
                 for c in (tree[v - n][0], tree[v - n][1])]
    return result


def _condense(tree, min_cluster_size):
    """sklearn's _condense_tree: rows (parent, child, lambda, size)."""
    n = len(tree) + 1
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    nxt = n + 1
    ignore = np.zeros(root + 1, bool)
    rows = []
    for node in _bfs(tree, root, n):
        if ignore[node] or node < n:
            continue
        left, right, d, _ = tree[node - n]
        lam = 1.0 / d if d > 0.0 else np.inf
        lc = tree[left - n][3] if left >= n else 1
        rc = tree[right - n][3] if right >= n else 1
        p = relabel[node]
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[left] = nxt
            rows.append((p, nxt, lam, lc))
            relabel[right] = nxt + 1
            rows.append((p, nxt + 1, lam, rc))
            nxt += 2
            continue
        shed = []
        if lc < min_cluster_size:
            shed.append(left)
        else:
            relabel[left] = p
        if rc < min_cluster_size:
            shed.append(right)
        else:
            relabel[right] = p
        for side in shed:
            for sub in _bfs(tree, side, n):
                if sub < n:
                    rows.append((p, sub, lam, 1))
                ignore[sub] = True
    return rows


def _stability(rows):
    """sklearn's _compute_stability: {cluster: sum of (lambda - birth) *
    size over its rows}, accumulated in row order."""
    parent = np.array([r[0] for r in rows], np.int64)
    child = np.array([r[1] for r in rows], np.int64)
    lam = np.array([r[2] for r in rows], np.float64)
    size = np.array([r[3] for r in rows], np.float64)
    smallest = int(parent.min())
    births = np.full(max(int(child.max()), smallest) + 1, np.nan)
    births[child] = lam
    births[smallest] = 0.0
    result = np.zeros(int(parent.max()) - smallest + 1)
    with np.errstate(invalid="ignore"):
        np.add.at(result, parent - smallest, (lam - births[parent]) * size)
    return {c + smallest: result[c] for c in range(len(result))}


def _eom_clusters(rows, stability):
    """sklearn's _get_clusters, excess of mass, no single cluster: the
    selected cluster ids."""
    node_list = sorted(stability.keys(), reverse=True)[:-1]
    tree = [r for r in rows if r[3] > 1]
    children = {}
    for p, c, _, _ in tree:
        children.setdefault(p, []).append(c)
    is_cluster = {c: True for c in node_list}
    for node in node_list:
        sub = np.sum([stability[c] for c in children.get(node, [])])
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            queue = list(children.get(node, []))
            while queue:
                is_cluster[queue[0]] = False
                queue = queue[1:] + children.get(queue[0], [])
    return sorted(c for c in is_cluster if is_cluster[c])


def hdbscan(points, min_cluster_size=5, device=None):
    """(N, F) -> (N,) int64 labels of sklearn's HDBSCAN(min_cluster_size)
    with its other defaults, -1 for noise. Needs N > 1 and N >=
    min_cluster_size, as sklearn does. The spanning tree is computed on
    `device` (CUDA unless another device is named), the rest on the
    host."""
    x = np.ascontiguousarray(points, np.float64)
    n = len(x)
    if n < 2 or n < min_cluster_size:
        raise ValueError(f"hdbscan needs more than one point and at least "
                         f"min_cluster_size={min_cluster_size}, got {n}")
    core = _core_distances(x, min_cluster_size)
    src, dst, dist = _prim_mst(x, core, resolve_device(device))
    order = np.argsort(dist)
    tree = _single_linkage(src[order], dst[order], dist[order])
    rows = _condense(tree, min_cluster_size)
    selected = _eom_clusters(rows, _stability(rows))
    # each point takes its first selected ancestor; under the root, noise
    label_of = {c: k for k, c in enumerate(selected)}
    up = {}
    for p, c, _, size in rows:
        if size > 1:
            up[c] = p
    labels = np.full(n, -1, np.int64)
    for p, c, _, size in rows:
        if size != 1 or c >= n:
            continue
        v = p
        while v not in label_of and v in up:
            v = up[v]
        labels[c] = label_of.get(v, -1)
    return labels
