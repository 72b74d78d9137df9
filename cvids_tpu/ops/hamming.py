"""Batched 256-bit binary-descriptor Hamming matching.

Array-program replacement for the reference's brute-force BRIEF matcher
(`/root/reference/server_pose_graph/src/server_keyframe.cpp:294-378`):
descriptors are ``uint32 (N, 8)`` arrays (the AgentMsg wire format packs them
as 4×int64 per descriptor, `agent_msg/msg/AgentMsg.msg:11-14`; we use
uint32 words), distance is XOR + popcount, and the whole N×M distance
matrix is produced in one fused pass — no per-feature loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["hamming_distance_matrix", "match_descriptors", "MatchResult",
           "pack_bits", "unpack_bits"]

# Acceptance gates mirroring `ServerKeyFrame::SearchInArea`
# (`server_keyframe.cpp:294-332`): best distance < 80 and best < 0.7 * second.
DEFAULT_MAX_DIST = 80
DEFAULT_RATIO = 0.7


class MatchResult(NamedTuple):
    """indices: (N,) best match in B per A row; valid: (N,) bool mask."""

    indices: jax.Array
    distances: jax.Array
    valid: jax.Array


def hamming_distance_matrix(a: jax.Array, b: jax.Array,
                            a_valid: jax.Array | None = None,
                            b_valid: jax.Array | None = None) -> jax.Array:
    """Pairwise Hamming distances between uint32 descriptor sets.

    a: (N, W) uint32, b: (M, W) uint32 -> (N, M) int32. Invalid rows get
    distance 512 (> any real 256-bit distance).
    """
    x = jax.lax.population_count(a[:, None, :] ^ b[None, :, :])
    d = jnp.sum(x.astype(jnp.int32), axis=-1)
    if a_valid is not None:
        d = jnp.where(a_valid[:, None], d, 512)
    if b_valid is not None:
        d = jnp.where(b_valid[None, :], d, 512)
    return d


def match_descriptors(a: jax.Array, b: jax.Array,
                      a_valid: jax.Array | None = None,
                      b_valid: jax.Array | None = None,
                      max_dist: int = DEFAULT_MAX_DIST,
                      ratio: float = DEFAULT_RATIO,
                      cross_check: bool = False) -> MatchResult:
    """Best-match with absolute + Lowe ratio gates (reference semantics).

    A row matches iff best < max_dist and best < ratio * second_best
    (second-best test skipped when M == 1, as in the reference's early-exit).
    """
    d = hamming_distance_matrix(a, b, a_valid, b_valid)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    if d.shape[1] > 1:
        d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(512)
        second = jnp.min(d2, axis=1)
        ok = (best < max_dist) & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    else:
        ok = best < max_dist
    if cross_check:
        rev_best = jnp.argmin(d, axis=0)  # for each B column, best A row
        ok = ok & (rev_best[best_idx] == jnp.arange(d.shape[0]))
    if a_valid is not None:
        ok = ok & a_valid
    return MatchResult(best_idx, best, ok)


def pack_bits(bits: jax.Array) -> jax.Array:
    """(..., 256) {0,1} -> (..., 8) uint32, little-endian within each word."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1).astype(jnp.uint32)


def unpack_bits(words: jax.Array) -> jax.Array:
    """(..., 8) uint32 -> (..., 256) {0,1} uint8."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(words.shape[:-1] + (256,)).astype(jnp.uint8)
