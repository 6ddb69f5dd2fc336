"""Pathfinding (the port's ``fyrox_tpu.utils.astar``).

fyrox-impl/src/utils/astar.rs (grid / graph A*). Two implementations:

  * ``astar``: host numpy A* over an explicit graph (vertices +
    adjacency), the reference's per-query use on the game thread;
    ``build_grid_graph`` makes a 4-connected grid graph.
  * ``distance_field``: batched Bellman-Ford relaxation on the device,
    shortest-path distances from per-world sources over a padded adjacency
    table (``pack_adjacency``). A plain loop of gather + min rounds with no
    host read, so it runs inside a captured CUDA graph.
"""
from __future__ import annotations

import heapq
from typing import List

import numpy as np
import torch

__all__ = ["astar", "distance_field", "build_grid_graph", "pack_adjacency"]


def astar(vertices: np.ndarray, neighbors: List[List[int]], start: int,
          goal: int) -> List[int]:
    """A* over a graph with Euclidean heuristic. Returns vertex index path
    (start..goal inclusive), or [] when unreachable."""
    n = len(vertices)
    if start == goal:
        return [start]
    dist = np.full(n, np.inf)
    dist[start] = 0.0
    came = np.full(n, -1, np.int64)
    h = np.linalg.norm(vertices - vertices[goal], axis=-1)
    open_heap = [(h[start], start)]
    closed = np.zeros(n, bool)
    while open_heap:
        _, u = heapq.heappop(open_heap)
        if u == goal:
            path = [goal]
            while path[-1] != start:
                path.append(int(came[path[-1]]))
            return path[::-1]
        if closed[u]:
            continue
        closed[u] = True
        for v in neighbors[u]:
            nd = dist[u] + np.linalg.norm(vertices[u] - vertices[v])
            if nd < dist[v]:
                dist[v] = nd
                came[v] = u
                heapq.heappush(open_heap, (nd + h[v], v))
    return []


def build_grid_graph(width: int, height: int, blocked=None):
    """4-connected grid graph (the reference's grid benches use the same
    construction). Returns (vertices [N,3], neighbors list)."""
    verts = np.zeros((width * height, 3), np.float32)
    neighbors: List[List[int]] = [[] for _ in range(width * height)]
    blocked = set() if blocked is None else set(blocked)
    for y in range(height):
        for x in range(width):
            i = y * width + x
            verts[i] = (x, 0, y)
            if i in blocked:
                continue
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nx, ny = x + dx, y + dy
                j = ny * width + nx
                if 0 <= nx < width and 0 <= ny < height and j not in blocked:
                    neighbors[i].append(j)
    return verts, neighbors


def pack_adjacency(vertices, neighbors, max_degree=None, device="cuda"):
    """Pad the neighbour lists into [N, D] index (int32) and weight
    (float32, inf = no edge) tensors for ``distance_field``, on `device`
    (the card unless asked otherwise)."""
    n = len(neighbors)
    d = max_degree or max((len(nb) for nb in neighbors), default=1)
    idx = np.zeros((n, d), np.int32)
    w = np.full((n, d), np.inf, np.float32)
    for i, nb in enumerate(neighbors):
        for k, j in enumerate(nb[:d]):
            idx[i, k] = j
            w[i, k] = np.linalg.norm(vertices[i] - vertices[j])
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


def distance_field(adj_idx, adj_w, sources, num_iters=None):
    """Batched Bellman-Ford: shortest distances from `sources`.

    adj_idx [N, D] int, adj_w [N, D] float32 (inf = no edge); sources [Wb]
    int (one source a world) or [Wb, N] bool masks. Returns [Wb, N]
    float32 distances (inf where unreachable) after `num_iters` rounds,
    by default 2·sqrt(N) + 8 (about an open grid's diameter: a walled
    graph needs as many rounds as its longest shortest path has edges).
    Each round is a gather of [Wb, N, D] and a min, with no host read."""
    n = adj_idx.shape[0]
    dev = adj_w.device
    if sources.dim() == 1:
        src_mask = torch.zeros((sources.shape[0], n), dtype=torch.bool,
                               device=dev)
        src_mask[torch.arange(sources.shape[0], device=dev),
                 sources.to(dev).long()] = True
    else:
        src_mask = sources.to(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dist = torch.where(src_mask, zero, torch.full_like(zero, float("inf")))
    iters = num_iters or int(2 * np.sqrt(n) + 8)
    idx = adj_idx.long()
    w = adj_w[None]
    for _ in range(iters):
        nbd = dist[:, idx] + w                           # [Wb, N, D]
        dist = torch.minimum(dist, nbd.amin(-1))
    return dist
