"""Chunk meshing + PLY export.

The `ChunkManager::RecomputeMeshes` role (`/root/reference/OpenChisel/
open_chisel/src/ChunkManager.cpp:91-168`): every dirty chunk gets an
(S+1)³ sample block (own voxels + one layer gathered from +x/+y/+z
neighbors, so meshes are seamless across chunks), runs marching tetrahedra,
and the fixed-slot triangles are compacted host-side. PLY output mirrors
`open_chisel/src/io/PLY.cpp` / the SaveMesh service.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.marching_cubes import marching_tets
from .tsdf import TsdfVolume

__all__ = ["extract_mesh", "write_ply", "read_ply"]


@partial(jax.jit, static_argnums=(4,))
def _mesh_chunk_batch(sdf_blocks, wgt_blocks, origins, col_blocks, voxel_size):
    return jax.vmap(lambda s, w, o, c: marching_tets(s, w, o, voxel_size, c))(
        sdf_blocks, wgt_blocks, origins, col_blocks)


def _gather_block(vol: TsdfVolume, coord: tuple, pool_np: tuple) -> tuple:
    """(S+1)³ sdf/weight/color block for one chunk (numpy gather).

    pool_np: (sdf, weight, color) numpy copies of the pool — fetched ONCE by
    the caller (one device->host pull instead of one per chunk)."""
    cfg = vol.cfg
    s = cfg.chunk_size
    sdf = np.zeros((s + 1, s + 1, s + 1), np.float32)
    wgt = np.zeros((s + 1, s + 1, s + 1), np.float32)
    col = np.zeros((s + 1, s + 1, s + 1, 3), np.float32)
    pool_sdf, pool_w, pool_c = pool_np
    # sample index (x, y, z) in 0..S maps to neighbor chunk (x//S, y//S, z//S)
    # and local voxel (x%S, y%S, z%S)
    idx = np.arange(s + 1)
    nx, lx = idx // s, idx % s
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                nb = (coord[0] + dx, coord[1] + dy, coord[2] + dz)
                slot = vol.slot_of.get(nb)
                if slot is None:
                    continue
                zi = np.nonzero(nx == dz)[0]
                yi = np.nonzero(nx == dy)[0]
                xi = np.nonzero(nx == dx)[0]
                sub = np.ix_(zi, yi, xi)
                sdf[sub] = pool_sdf[slot][np.ix_(lx[zi], lx[yi], lx[xi])]
                wgt[sub] = pool_w[slot][np.ix_(lx[zi], lx[yi], lx[xi])]
                col[sub] = pool_c[slot][np.ix_(lx[zi], lx[yi], lx[xi])]
    return sdf, wgt, col


def extract_mesh(vol: TsdfVolume, chunks: list[tuple] | None = None,
                 batch: int = 64):
    """Mesh the given (default: all occupied) chunks.

    Returns (verts, colors, normals) — each (T, 3, 3) float32, compacted.
    Normals are outward SDF-gradient vertex normals (the reference computes
    these per mesh vertex, `ChunkManager.cpp:259-296`).
    """
    cfg = vol.cfg
    s = cfg.chunk_size
    if chunks is None:
        chunks = list(vol.slot_of.keys())
    empty = np.zeros((0, 3, 3), np.float32)
    if not chunks:
        return empty, empty.copy(), empty.copy()
    all_v, all_c, all_n = [], [], []
    pool_np = (np.asarray(vol.pool.sdf), np.asarray(vol.pool.weight),
               np.asarray(vol.pool.color))
    # pad to a full batch with a never-allocated chunk (zero weight -> no
    # triangles) so the jitted mesh kernel compiles for one batch size only
    pad_coord = (2 ** 20, 2 ** 20, 2 ** 20)
    n_pad = (-len(chunks)) % batch
    chunks = list(chunks) + [pad_coord] * n_pad
    for start in range(0, len(chunks), batch):
        cs = chunks[start:start + batch]
        blocks = [_gather_block(vol, c, pool_np) for c in cs]
        sdf_b = jnp.asarray(np.stack([b[0] for b in blocks]))
        wgt_b = jnp.asarray(np.stack([b[1] for b in blocks]))
        col_b = jnp.asarray(np.stack([b[2] for b in blocks]))
        origins = jnp.asarray(
            np.asarray(cs, np.float32) * (s * cfg.voxel_size)
            + 0.5 * cfg.voxel_size)
        v, ok, c, nrm = _mesh_chunk_batch(sdf_b, wgt_b, origins, col_b,
                                          cfg.voxel_size)
        okn = np.asarray(ok)
        all_v.append(np.asarray(v)[okn])
        all_c.append(np.asarray(c)[okn])
        all_n.append(np.asarray(nrm)[okn])
    verts = np.concatenate(all_v) if all_v else empty
    cols = np.concatenate(all_c) if all_c else empty.copy()
    norms = np.concatenate(all_n) if all_n else empty.copy()
    return verts, cols, norms


def write_ply(path: str, verts: np.ndarray, colors: np.ndarray | None = None,
              normals: np.ndarray | None = None):
    """Triangle soup -> binary-little-endian PLY (the reference's mesh-save
    output format, `open_chisel/src/io/PLY.cpp`; per-vertex nx/ny/nz match
    the reference's gradient normals in the saved mesh)."""
    t = len(verts)
    v = verts.reshape(-1, 3).astype(np.float32)
    n = len(v)
    has_c = colors is not None and len(colors)
    has_n = normals is not None and len(normals)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if has_n:
            hdr += ["property float nx", "property float ny",
                    "property float nz"]
        if has_c:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {t}", "property list uchar int vertex_index",
                "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        fields = [("xyz", np.float32, 3)]
        if has_n:
            fields.append(("n", np.float32, 3))
        if has_c:
            fields.append(("rgb", np.uint8, 3))
        rec = np.zeros(n, dtype=fields)
        rec["xyz"] = v
        if has_n:
            rec["n"] = normals.reshape(-1, 3).astype(np.float32)
        if has_c:
            rec["rgb"] = np.clip(colors.reshape(-1, 3), 0, 255).astype(np.uint8)
        f.write(rec.tobytes())
        faces = np.zeros(t, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        faces["n"] = 3
        faces["idx"] = np.arange(3 * t, dtype=np.int32).reshape(-1, 3)
        f.write(faces.tobytes())


def read_ply(path: str):
    """Minimal reader for the writer above (tests/round-trips).

    Returns (verts (N, 3), face_count, normals (N, 3) or None)."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    n = t = 0
    has_c = has_n = False
    for ln in lines:
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        elif ln.startswith("element face"):
            t = int(ln.split()[-1])
        elif "uchar red" in ln:
            has_c = True
        elif "float nx" in ln:
            has_n = True
    fields = [("xyz", np.float32, 3)]
    if has_n:
        fields.append(("n", np.float32, 3))
    if has_c:
        fields.append(("rgb", np.uint8, 3))
    rec = np.frombuffer(body, dtype=fields, count=n)
    return (rec["xyz"].copy(), t, rec["n"].copy() if has_n else None)
