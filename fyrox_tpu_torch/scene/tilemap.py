"""TileMap: tile sets, grid data, render mesh + collider extraction (the
port's copy of ``fyrox_tpu.scene.tilemap``; host only: the mesh is the
port's MeshData and the colliders go into the port's PhysicsBuilder).

Equivalent of the reference's TileMap node family (fyrox-impl/src/scene/
tilemap/: tile sets, map data, collider shapes). A tile map here is a
dense [H,W] int grid of tile ids into a TileSet; rendering emits one
quad per occupied cell (instanced into a single MeshData), and physics
extracts greedily merged cuboid colliders from solid cells (the
reference's tilemap collider shapes reduce to rapier cuboids the same
way).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from fyrox_tpu_torch.physics.shapes import CUBOID
from fyrox_tpu_torch.physics.world import BodyType
from fyrox_tpu_torch.render.mesh import MeshData
from fyrox_tpu_torch.utils.autotile import autotile_bitmask, wfc_collapse

__all__ = ["TileDef", "TileSet", "TileMap", "tilemap_mesh",
           "tilemap_collider_boxes", "tilemap_property_layer",
           "apply_autotile", "tilemap_from_wfc", "tilemap_to_physics"]

EMPTY = -1


@dataclass
class TileDef:
    """One tile kind (tilemap/tileset.rs TileDefinition essentials).

    `properties`: arbitrary named values (the reference's tile property
    layers, fyrox-impl/src/scene/tilemap/tileset.rs) — query per-cell
    grids with `tilemap_property_layer`."""
    color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    solid: bool = False             # participates in collider extraction
    properties: Dict[str, float] = field(default_factory=dict)


@dataclass
class TileSet:
    tiles: List[TileDef] = field(default_factory=list)

    def add(self, **kw) -> int:
        self.tiles.append(TileDef(**kw))
        return len(self.tiles) - 1


@dataclass
class TileMap:
    """Dense tile grid in the XY plane (2D games), cell size in world
    units; grid[y, x] = tile id or EMPTY."""
    tile_set: TileSet
    grid: np.ndarray
    cell_size: float = 1.0
    origin: Tuple[float, float] = (0.0, 0.0)

    @property
    def shape(self):
        return self.grid.shape


def tilemap_mesh(tm: TileMap) -> MeshData:
    """One flat quad per occupied cell, vertex-colored by tile."""
    h, w = tm.grid.shape
    cs = tm.cell_size
    ox, oy = tm.origin
    pos, nrm, uv, tris, cols = [], [], [], [], []
    voff = 0
    for y in range(h):
        for x in range(w):
            tid = int(tm.grid[y, x])
            if tid == EMPTY:
                continue
            x0, y0 = ox + x * cs, oy + y * cs
            quad = [(x0, y0, 0), (x0 + cs, y0, 0),
                    (x0 + cs, y0 + cs, 0), (x0, y0 + cs, 0)]
            pos.extend(quad)
            nrm.extend([(0, 0, 1)] * 4)
            uv.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
            tris.extend([(voff, voff + 1, voff + 2),
                         (voff, voff + 2, voff + 3)])
            cols.append(tm.tile_set.tiles[tid].color)
            voff += 4
    mesh = MeshData(np.asarray(pos, np.float32).reshape(-1, 3),
                    np.asarray(nrm, np.float32).reshape(-1, 3),
                    np.asarray(uv, np.float32).reshape(-1, 2),
                    np.asarray(tris, np.int32).reshape(-1, 3))
    return mesh


def tilemap_collider_boxes(tm: TileMap):
    """Greedy rectangle merge of solid cells → [(cx, cy, hx, hy), ...]
    (centers + half-extents, world units) for cuboid colliders — the
    standard tilemap collider reduction."""
    h, w = tm.grid.shape
    solid = np.zeros((h, w), bool)
    for y in range(h):
        for x in range(w):
            tid = int(tm.grid[y, x])
            solid[y, x] = tid != EMPTY and tm.tile_set.tiles[tid].solid
    used = np.zeros_like(solid)
    boxes = []
    cs = tm.cell_size
    ox, oy = tm.origin
    for y in range(h):
        for x in range(w):
            if not solid[y, x] or used[y, x]:
                continue
            # grow right
            x1 = x
            while x1 + 1 < w and solid[y, x1 + 1] and not used[y, x1 + 1]:
                x1 += 1
            # grow down while the whole row span stays solid
            y1 = y
            while (y1 + 1 < h
                   and np.all(solid[y1 + 1, x:x1 + 1])
                   and not np.any(used[y1 + 1, x:x1 + 1])):
                y1 += 1
            used[y:y1 + 1, x:x1 + 1] = True
            wx = (x1 - x + 1) * cs
            wy = (y1 - y + 1) * cs
            boxes.append((ox + x * cs + wx / 2, oy + y * cs + wy / 2,
                          wx / 2, wy / 2))
    return boxes


def tilemap_property_layer(tm: TileMap, name: str, default=0.0):
    """[H,W] float grid of a named tile property (tile property layers,
    fyrox-impl/src/scene/tilemap/tileset.rs): each cell takes its tile's
    `properties[name]`, `default` where empty/unset."""
    h, w = tm.grid.shape
    lut = np.asarray([t.properties.get(name, default)
                      for t in tm.tile_set.tiles], np.float32)
    out = np.full((h, w), float(default), np.float32)
    occ = tm.grid != EMPTY
    out[occ] = lut[tm.grid[occ]]
    return out


def apply_autotile(tm: TileMap, terrain_ids, variant_table,
                   diagonal=True) -> TileMap:
    """Autotile↔tilemap bridge (fyrox-autotile ↔ tilemap, the reference's
    autotile bridge in fyrox-impl/src/scene/tilemap/): cells holding any
    tile in `terrain_ids` are treated as one terrain; each is replaced by
    `variant_table[bitmask]` (blob 8-neighbor bitmask from
    utils.autotile.autotile_bitmask; missing masks keep the original
    tile). Returns a new TileMap sharing the tile set."""
    terrain_ids = set(int(i) for i in terrain_ids)
    filled = np.isin(tm.grid, list(terrain_ids))
    mask = autotile_bitmask(filled, diagonal=diagonal)
    grid = tm.grid.copy()
    h, w = grid.shape
    for y in range(h):
        for x in range(w):
            m = int(mask[y, x])
            if m >= 0 and m in variant_table:
                grid[y, x] = variant_table[m]
    return TileMap(tile_set=tm.tile_set, grid=grid,
                   cell_size=tm.cell_size, origin=tm.origin)


def tilemap_from_wfc(model, tile_set: TileSet, height, width,
                     wfc_to_tile=None, seed=0, cell_size=1.0,
                     origin=(0.0, 0.0)) -> TileMap:
    """Generate a TileMap by wave-function collapse (the fyrox-autotile
    WFC → tilemap placement path): `model` is utils.autotile.WfcModel;
    `wfc_to_tile` maps WFC tile index → tile-set id (identity default)."""
    grid = np.asarray(wfc_collapse(model, height, width, seed=seed))
    if wfc_to_tile is not None:
        lut = np.asarray([int(wfc_to_tile[i]) for i in range(model.num_tiles)])
        grid = lut[grid]
    return TileMap(tile_set=tile_set, grid=grid.astype(np.int64),
                   cell_size=cell_size, origin=origin)


def tilemap_to_physics(tm: TileMap, pb, body=None, z_half=0.5,
                       friction=0.6):
    """Attach the tilemap's merged solid rectangles as static cuboid
    colliders (the reference's tilemap collider shape extraction reduced
    to rapier cuboids). Returns (body index, number of colliders)."""
    if body is None:
        body = pb.add_body(body_type=BodyType.STATIC)
    boxes = tilemap_collider_boxes(tm)
    for (cx, cy, hx, hy) in boxes:
        pb.add_collider(body, CUBOID, [hx, hy, z_half],
                        offset=(cx, cy, 0.0), friction=friction)
    return body, len(boxes)
