"""Isosurface extraction via marching tetrahedra, batched over cubes.

Plays the role of OpenChisel's marching cubes (`/root/reference/OpenChisel/
open_chisel/include/open_chisel/marching_cubes/MarchingCubes.h:35-130`, the
256-entry triangle table). Marching *tetrahedra* is chosen instead: each cube
splits into 6 tetrahedra whose 16-case triangle table is generated
programmatically below (no hand-transcribed 256×16 table to get wrong), the
output is watertight across cube and chunk boundaries, and the per-tet work
is a fixed-shape masked gather — ideal for vmap. Cost: ≤12 triangles per
cube vs MC's ≤5, irrelevant at mesh-publishing rates.

Convention: sdf < 0 is inside the object; triangles are oriented so normals
point toward positive sdf (outside), enforced via the tet's exact linear
field gradient.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["marching_tets", "CUBE_CORNERS", "TETS"]

# cube corner offsets (x, y, z)
CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# 6-tetrahedra decomposition of the cube around the 0-6 diagonal
TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32)

# tet edges as (corner_a, corner_b) local indices 0..3
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)


def _build_tet_table() -> np.ndarray:
    """(16, 2, 3) edge-index triangles per inside-mask case; -1 = unused.

    Case bit i set <=> tet vertex i is inside (sdf < 0).
    """
    def edge_id(a, b):
        for k, (x, y) in enumerate(TET_EDGES):
            if {a, b} == {x, y}:
                return k
        raise AssertionError

    table = -np.ones((16, 2, 3), np.int32)
    for case in range(16):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if i not in inside]
        if len(inside) == 1:
            i = inside[0]
            tri = [edge_id(i, o) for o in outside]
            table[case, 0] = tri
        elif len(inside) == 3:
            o = outside[0]
            tri = [edge_id(o, i) for i in inside]
            table[case, 0] = tri
        elif len(inside) == 2:
            i0, i1 = inside
            o0, o1 = outside
            e00, e01 = edge_id(i0, o0), edge_id(i0, o1)
            e10, e11 = edge_id(i1, o0), edge_id(i1, o1)
            table[case, 0] = [e00, e01, e11]
            table[case, 1] = [e00, e11, e10]
    return table


TET_TABLE = _build_tet_table()


def marching_tets(sdf: jax.Array, wgt: jax.Array, origin: jax.Array,
                  voxel_size: float, color: jax.Array | None = None):
    """Extract triangles from one (S+1, S+1, S+1) sdf block.

    sdf/wgt indexed [z][y][x]; `origin` is the world position of sample
    (0,0,0) (voxel center). Returns (verts (T, 3, 3), valid (T,),
    vert_colors (T, 3, 3) or None, vert_normals (T, 3, 3)) with
    T = S³·6·2 fixed slots. Normals are the normalized SDF gradient of the
    containing tet's exact linear field — outward-pointing (toward positive
    sdf), the role of OpenChisel's central-difference vertex normals
    (`ChunkManager.cpp:259-296`).
    """
    s = sdf.shape[0] - 1
    # corner samples per cube: (S³, 8)
    gz, gy, gx = jnp.meshgrid(jnp.arange(s), jnp.arange(s), jnp.arange(s),
                              indexing="ij")
    base = jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)  # (C, 3) xyz
    corners = base[:, None, :] + jnp.asarray(CUBE_CORNERS)[None]  # (C, 8, 3)
    cx, cy, cz = corners[..., 0], corners[..., 1], corners[..., 2]
    vals = sdf[cz, cy, cx]          # (C, 8)
    wvals = wgt[cz, cy, cx]
    cube_ok = jnp.all(wvals > 0.0, axis=-1)
    pos = corners.astype(jnp.float32) * voxel_size + origin[None, None, :]
    if color is not None:
        cols = color[cz, cy, cx]     # (C, 8, 3)

    tets = jnp.asarray(TETS)         # (6, 4)
    tv = vals[:, tets]               # (C, 6, 4)
    tp = pos[:, tets]                # (C, 6, 4, 3)
    tc = cols[:, tets] if color is not None else None

    # case index per tet
    bits = (tv < 0.0).astype(jnp.int32)
    case = (bits[..., 0] + 2 * bits[..., 1] + 4 * bits[..., 2]
            + 8 * bits[..., 3])      # (C, 6)

    # all 6 edge crossings (C, 6, 6edges, 3)
    ea = jnp.asarray(TET_EDGES[:, 0])
    eb = jnp.asarray(TET_EDGES[:, 1])
    va = tv[..., ea]                 # (C, 6, 6)
    vb = tv[..., eb]
    denom = va - vb
    t = jnp.where(jnp.abs(denom) > 1e-9, va / jnp.where(jnp.abs(denom) > 1e-9, denom, 1.0), 0.5)
    t = jnp.clip(t, 0.0, 1.0)
    pa = tp[..., ea, :]
    pb = tp[..., eb, :]
    cross = pa + t[..., None] * (pb - pa)  # (C, 6, 6, 3)
    if color is not None:
        ca = tc[..., ea, :]
        cb = tc[..., eb, :]
        ccross = ca + t[..., None] * (cb - ca)

    # gather triangles via the case table
    table = jnp.asarray(TET_TABLE)   # (16, 2, 3)
    tri_edges = table[case]          # (C, 6, 2, 3)
    tri_valid = tri_edges[..., 0] >= 0  # (C, 6, 2)
    safe_edges = jnp.maximum(tri_edges, 0)
    verts = jnp.take_along_axis(
        cross[:, :, None, :, :],     # (C, 6, 1, 6, 3)
        safe_edges[..., None].astype(jnp.int32),  # (C, 6, 2, 3, 1)
        axis=3)                      # (C, 6, 2, 3, 3)
    if color is not None:
        vcols = jnp.take_along_axis(ccross[:, :, None, :, :],
                                    safe_edges[..., None].astype(jnp.int32), axis=3)

    # orientation: flip so normal agrees with the tet's linear-field gradient
    e1 = verts[..., 1, :] - verts[..., 0, :]
    e2 = verts[..., 2, :] - verts[..., 0, :]
    normal = jnp.cross(e1, e2)       # (C, 6, 2, 3)
    # gradient of the linear field on the tet: solve from corner deltas
    d10 = tp[..., 1, :] - tp[..., 0, :]
    d20 = tp[..., 2, :] - tp[..., 0, :]
    d30 = tp[..., 3, :] - tp[..., 0, :]
    # closed-form solve of [d10; d20; d30] @ g = rhs via the adjugate
    # (avoids a batched LAPACK-style solve in the hot mesh kernel)
    r1 = tv[..., 1] - tv[..., 0]
    r2 = tv[..., 2] - tv[..., 0]
    r3 = tv[..., 3] - tv[..., 0]
    c23 = jnp.cross(d20, d30)
    c31 = jnp.cross(d30, d10)
    c12 = jnp.cross(d10, d20)
    det = jnp.sum(d10 * c23, axis=-1, keepdims=True)
    grad = (r1[..., None] * c23 + r2[..., None] * c31 + r3[..., None] * c12) \
        / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)  # (C, 6, 3)
    flip = jnp.sum(normal * grad[:, :, None, :], -1) < 0.0  # (C, 6, 2)
    v1 = jnp.where(flip[..., None, None], verts[..., [0, 2, 1], :], verts)

    # per-vertex normals: the tet's linear-field gradient, normalized —
    # constant within the tet, shared by both triangle slots and all 3
    # vertices (outward by construction: grad points toward positive sdf)
    gn = grad / jnp.maximum(
        jnp.linalg.norm(grad, axis=-1, keepdims=True), 1e-12)   # (C, 6, 3)
    vnorm = jnp.broadcast_to(gn[:, :, None, None, :], v1.shape)

    valid = tri_valid & cube_ok[:, None, None]
    tcount = s ** 3 * 6 * 2
    out_v = v1.reshape(tcount, 3, 3)
    out_ok = valid.reshape(tcount)
    out_c = vcols.reshape(tcount, 3, 3) if color is not None else None
    out_n = vnorm.reshape(tcount, 3, 3)
    return out_v, out_ok, out_c, out_n
