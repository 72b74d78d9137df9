"""Basic image ops: separable Gaussian blur, Sobel gradients, bilinear
sampling, pyramid construction. All pure XLA, batched, jit-safe.

These back the feature front-end (BRIEF blur, KLT pyramids) and the dense
mapper (gradient maps mirroring `sgm_stereo_mapper.cpp:55-123`'s Sobel use).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["gaussian_kernel1d", "gaussian_blur", "sobel", "bilinear_sample",
           "downsample2x", "build_pyramid", "image_gradients"]


def gaussian_kernel1d(sigma: float, radius: int | None = None, dtype=jnp.float32) -> jax.Array:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _conv1d(img: jax.Array, k: jax.Array, axis: int) -> jax.Array:
    """Separable 'same' convolution with edge replication along one axis."""
    r = (k.shape[0] - 1) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    x = jnp.pad(img, pad, mode="edge")
    # stack shifted views and contract — small kernels only.
    idx = [slice(None)] * img.ndim
    taps = []
    for i in range(k.shape[0]):
        s = list(idx)
        s[axis] = slice(i, i + img.shape[axis])
        taps.append(x[tuple(s)])
    return jnp.tensordot(k, jnp.stack(taps), axes=[[0], [0]]).astype(img.dtype)


def gaussian_blur(img: jax.Array, sigma: float, radius: int | None = None) -> jax.Array:
    """Gaussian blur of (..., H, W) images (σ=2, radius 4 matches the
    reference's BRIEF pre-blur, `ThirdParty/DVision/BRIEF.cpp:43-106`)."""
    k = gaussian_kernel1d(sigma, radius, dtype=jnp.float32)
    out = _conv1d(img.astype(jnp.float32), k, img.ndim - 2)
    return _conv1d(out, k, img.ndim - 1)


def sobel(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sobel gx, gy for (..., H, W) float images (standard 3x3, no scaling)."""
    img = img.astype(jnp.float32)
    smooth = jnp.asarray([1.0, 2.0, 1.0], jnp.float32)
    diff = jnp.asarray([-1.0, 0.0, 1.0], jnp.float32)
    gx = _conv1d(_conv1d(img, diff, img.ndim - 1), smooth, img.ndim - 2)
    gy = _conv1d(_conv1d(img, diff, img.ndim - 2), smooth, img.ndim - 1)
    return gx, gy


def image_gradients(img: jax.Array) -> jax.Array:
    """Gradient magnitude |∇I| from Sobel (used for SGM penalty modulation)."""
    gx, gy = sobel(img)
    return jnp.sqrt(gx * gx + gy * gy)


def bilinear_sample(img: jax.Array, xy: jax.Array, fill: float = 0.0) -> jax.Array:
    """Sample (H, W) image at (..., 2) float pixel coords (x, y).

    Out-of-bounds coordinates return `fill`. Pure gather formulation.
    """
    h, w = img.shape[-2], img.shape[-1]
    x, y = xy[..., 0], xy[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def tap(yi, xi):
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        return img[..., yc, xc]

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return jnp.where(inside, out, fill)


def downsample2x(img: jax.Array) -> jax.Array:
    """2×2 average-pool downsample of (..., H, W); H, W must be even."""
    h, w = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : h * 2, : w * 2]
    x = x.reshape(x.shape[:-2] + (h, 2, w, 2))
    return jnp.mean(x.astype(jnp.float32), axis=(-3, -1))


def build_pyramid(img: jax.Array, levels: int) -> list[jax.Array]:
    """Gaussian-ish pyramid: level 0 = input, each next = blur + 2x downsample."""
    pyr = [img.astype(jnp.float32)]
    for _ in range(levels - 1):
        pyr.append(downsample2x(gaussian_blur(pyr[-1], 1.0, 1)))
    return pyr
