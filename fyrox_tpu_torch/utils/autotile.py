"""Autotiling + wave-function collapse (fyrox-autotile/src/lib.rs parity;
the port's copy of ``fyrox_tpu.utils.autotile``: the same seeds give the
same grids).

Two authoring-time tools, host-side like the reference crate:

  * `autotile_bitmask` — deterministic 8-neighbor autotiling: each filled
    cell gets a variant index from the bitmask of its filled neighbors
    (the standard 47/16-tile blob scheme; callers map masks → art).
  * `WfcModel` / `wfc_collapse` — constraint-based wave function collapse
    over pairwise adjacency rules with min-entropy cell selection and
    constraint propagation (AC-3 style), seeded for determinism like the
    reference's deterministic generator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = ["autotile_bitmask", "WfcModel", "wfc_collapse"]

# neighbor order: bit 0..7 = N, NE, E, SE, S, SW, W, NW
_OFFS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def autotile_bitmask(filled, diagonal=True):
    """[H,W] bool → [H,W] int mask per filled cell (-1 where empty).

    Corner bits only count when both adjacent edges are filled (blob
    convention, so the mask space collapses to the canonical 47 tiles).
    """
    filled = np.asarray(filled, bool)
    h, w = filled.shape
    pad = np.zeros((h + 2, w + 2), bool)
    pad[1:-1, 1:-1] = filled
    nb = [pad[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] for dy, dx in _OFFS]
    n_, ne, e, se, s_, sw, w_, nw = nb
    if diagonal:
        ne = ne & n_ & e
        se = se & s_ & e
        sw = sw & s_ & w_
        nw = nw & n_ & w_
    mask = (n_ * 1 + ne * 2 + e * 4 + se * 8 + s_ * 16 + sw * 32
            + w_ * 64 + nw * 128)
    return np.where(filled, mask, -1)


@dataclass
class WfcModel:
    """Pairwise adjacency constraints: allowed[d][a] = set of tiles that
    may sit in direction d (0=N,1=E,2=S,3=W) of tile a."""
    num_tiles: int
    allowed: List[List[Set[int]]] = field(default=None)
    weights: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.allowed is None:
            self.allowed = [[set(range(self.num_tiles))
                             for _ in range(self.num_tiles)]
                            for _ in range(4)]
        if self.weights is None:
            self.weights = np.ones(self.num_tiles, np.float64)

    @staticmethod
    def from_pairs(num_tiles, pairs):
        """pairs: iterable of (a, b, direction) meaning b may sit in
        `direction` of a; the reverse direction is implied."""
        m = WfcModel(num_tiles,
                     allowed=[[set() for _ in range(num_tiles)]
                              for _ in range(4)])
        opp = {0: 2, 1: 3, 2: 0, 3: 1}
        for a, b, d in pairs:
            m.allowed[d][a].add(b)
            m.allowed[opp[d]][b].add(a)
        return m

    @staticmethod
    def from_sample(sample):
        """Learn adjacency + weights from an example [H,W] tile grid
        (the classic WFC 'simple tiled' training pass)."""
        sample = np.asarray(sample)
        tiles = int(sample.max()) + 1
        pairs = []
        h, w = sample.shape
        for y in range(h):
            for x in range(w):
                if y > 0:
                    pairs.append((sample[y, x], sample[y - 1, x], 0))
                if x + 1 < w:
                    pairs.append((sample[y, x], sample[y, x + 1], 1))
        m = WfcModel.from_pairs(tiles, pairs)
        counts = np.bincount(sample.ravel(), minlength=tiles).astype(np.float64)
        m.weights = np.maximum(counts, 1e-3)
        return m


_DIRS = [(-1, 0), (0, 1), (1, 0), (0, -1)]   # N, E, S, W


def wfc_collapse(model: WfcModel, height, width, seed=0, max_restarts=16):
    """Collapse an [H,W] grid; returns int grid or raises on persistent
    contradiction. Deterministic for a given seed."""
    nt = model.num_tiles
    allow = np.zeros((4, nt, nt), bool)
    for d in range(4):
        for a in range(nt):
            for b in model.allowed[d][a]:
                allow[d, a, b] = True
    wts = model.weights

    for attempt in range(max_restarts):
        rng = np.random.default_rng(seed + attempt)
        poss = np.ones((height, width, nt), bool)
        ok = True
        while ok:
            counts = poss.sum(-1)
            if np.any(counts == 0):
                ok = False
                break
            open_cells = counts > 1
            if not np.any(open_cells):
                return np.argmax(poss, -1)
            # min-entropy cell (weighted), tiny noise for tie-breaking
            ent = np.where(open_cells,
                           counts + rng.random(counts.shape) * 0.1, np.inf)
            y, x = np.unravel_index(np.argmin(ent), ent.shape)
            opts = np.flatnonzero(poss[y, x])
            p = wts[opts] / wts[opts].sum()
            pick = rng.choice(opts, p=p)
            poss[y, x] = False
            poss[y, x, pick] = True
            # AC-3 propagation
            stack = [(y, x)]
            while stack:
                cy, cx = stack.pop()
                for d, (dy, dx) in enumerate(_DIRS):
                    ny, nx = cy + dy, cx + dx
                    if not (0 <= ny < height and 0 <= nx < width):
                        continue
                    feasible = np.any(allow[d][poss[cy, cx]], axis=0)
                    new = poss[ny, nx] & feasible
                    if not new.any():
                        ok = False
                        stack = []
                        break
                    if (new != poss[ny, nx]).any():
                        poss[ny, nx] = new
                        stack.append((ny, nx))
    raise RuntimeError("WFC contradiction persisted across restarts")
