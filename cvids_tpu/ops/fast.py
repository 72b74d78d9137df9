"""FAST-9/16 corner detection, fully vectorized.

Replaces the reference's per-keyframe `cv::FAST(img, keypoints, 20, true)`
(`/root/reference/server_pose_graph/src/server_keyframe.cpp:267-290`) and the
agent front-end's feature detection (contract: max 150 features, 30 px min
spacing, `config/euroc/euroc_config.yaml:44-45`). Instead of a scalar scan,
the segment test runs as 16 shifted-image elementwise comparisons; spatial
spreading uses grid-cell winners (jit-stable) rather than a greedy mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["fast_score_map", "select_keypoints", "Keypoints"]

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9


class Keypoints(NamedTuple):
    xy: jax.Array      # (K, 2) float32 pixel coords (x, y)
    score: jax.Array   # (K,)
    valid: jax.Array   # (K,) bool


def _shift(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """View of img shifted so out[y,x] = img[y+dy, x+dx], edge-padded."""
    h, w = img.shape[-2:]
    pad = 3
    x = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(pad, pad), (pad, pad)], mode="edge")
    return jax.lax.dynamic_slice_in_dim(
        jax.lax.dynamic_slice_in_dim(x, pad + dy, h, axis=img.ndim - 2),
        pad + dx, w, axis=img.ndim - 1)


def fast_score_map(img: jax.Array, threshold: float = 20.0,
                   nms: bool = True) -> jax.Array:
    """FAST-9 corner score map for (..., H, W) grayscale images.

    Score is the sum of threshold-exceeding contrast over the circle for the
    stronger polarity (proxy for OpenCV's max-threshold score — only ordering
    matters for NMS/top-K). Non-corners and (optionally) non-local-maxima
    score 0. A 3-pixel border is zeroed.
    """
    img = img.astype(jnp.float32)
    circle = jnp.stack([_shift(img, dy, dx) for dy, dx in _CIRCLE])  # (16, ..., H, W)
    bright = circle > img + threshold
    dark = circle < img - threshold

    def has_arc(mask):
        # run of ARC_LEN consecutive Trues on the ring (wrap-around)
        doubled = jnp.concatenate([mask, mask[: ARC_LEN - 1]], axis=0).astype(jnp.int32)
        csum = jnp.cumsum(doubled, axis=0)
        csum = jnp.concatenate([jnp.zeros_like(csum[:1]), csum], axis=0)
        runs = csum[ARC_LEN:] - csum[:-ARC_LEN]  # (16, ..., H, W)
        return jnp.max(runs, axis=0) >= ARC_LEN

    is_corner = has_arc(bright) | has_arc(dark)
    bright_sum = jnp.sum(jnp.maximum(circle - img - threshold, 0.0), axis=0)
    dark_sum = jnp.sum(jnp.maximum(img - threshold - circle, 0.0), axis=0)
    score = jnp.where(is_corner, jnp.maximum(bright_sum, dark_sum), 0.0)

    # zero 3-px border (circle taps there are replicated-edge artifacts)
    h, w = img.shape[-2:]
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    score = jnp.where(interior, score, 0.0)

    if nms:
        neigh = jnp.stack(
            [_shift(score, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dy, dx) != (0, 0)])
        score = jnp.where(score >= jnp.max(neigh, axis=0), score, 0.0)
    return score


def select_keypoints(score: jax.Array, max_num: int, cell: int = 30,
                     min_score: float = 1e-6,
                     existing_xy: jax.Array | None = None,
                     existing_valid: jax.Array | None = None,
                     min_dist: float | None = None) -> Keypoints:
    """Spatially-spread top-K: best corner per `cell`×`cell` grid cell, then
    global top-K by score. Mirrors the reference front-end's 30-px min-dist
    policy in a jit-stable way (one winner per cell ≈ min spacing ~cell).

    `existing_xy/valid`: already-tracked features; cells near them are
    suppressed (the reference masks a min_dist disc around tracked points).
    """
    h, w = score.shape[-2:]
    ncy, ncx = -(-h // cell), -(-w // cell)
    pad_h, pad_w = ncy * cell - h, ncx * cell - w
    s = jnp.pad(score, [(0, pad_h), (0, pad_w)])
    cells = s.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)
    best_in_cell = jnp.argmax(cells, axis=1)
    cell_score = jnp.take_along_axis(cells, best_in_cell[:, None], axis=1)[:, 0]
    cy = jnp.arange(ncy * ncx) // ncx
    cx = jnp.arange(ncy * ncx) % ncx
    py = cy * cell + best_in_cell // cell
    px = cx * cell + best_in_cell % cell

    if existing_xy is not None:
        d2 = (px[:, None] - existing_xy[None, :, 0]) ** 2 + (py[:, None] - existing_xy[None, :, 1]) ** 2
        if existing_valid is not None:
            d2 = jnp.where(existing_valid[None, :], d2, jnp.inf)
        r = (min_dist if min_dist is not None else cell) ** 2
        near = jnp.any(d2 < r, axis=1)
        cell_score = jnp.where(near, 0.0, cell_score)

    k = min(max_num, ncy * ncx)
    top_score, top_idx = jax.lax.top_k(cell_score, k)
    xy = jnp.stack([px[top_idx], py[top_idx]], axis=-1).astype(jnp.float32)
    valid = top_score > min_score
    if k < max_num:
        xy = jnp.pad(xy, [(0, max_num - k), (0, 0)])
        top_score = jnp.pad(top_score, [(0, max_num - k)])
        valid = jnp.pad(valid, [(0, max_num - k)])
    return Keypoints(xy, top_score, valid)
