"""Multi-view dense depth estimation pipeline (reference-keyframe centric).

Functional redesign of the reference's `DepthEstimator` + `StereoMapper`
(`/root/reference/server_pose_graph/src/dense_mapping/depth_estimator.cpp`,
`sgm_stereo_mapper.cpp`): a reference keyframe accumulates a plane-sweep cost
volume over subsequent measurement frames (running mean), optionally biased
toward sparse VIO depths, then SGM + WTA produce a depth measurement that a
Gaussian×Beta filter fuses; `finalize` masks unconverged pixels.

The whole per-frame fusion step is one jitted function
(`fuse_measurement`) — the reference's upload / cost-kernel / SGM / WTA /
download / CPU-filter chain collapses into a single XLA program with no
host↔device round-trips.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import costvolume, depth_filter, sgm
from ..ops.image import image_gradients

__all__ = ["DenseConfig", "DenseState", "init_reference", "fuse_measurement",
           "finalize", "splat_sparse"]


@dataclass(frozen=True)
class DenseConfig:
    """Defaults mirror `dense_mapping_parameters.h:19-53`: 128 hypotheses,
    DEP_SAMPLE = 1/(0.11·461), SGM pi1=16 pi2=64 tau_so=8, sparse bias 15."""

    height: int = 480
    width: int = 640
    num_depths: int = 128
    dep_sample: float = 1.0 / (0.11 * 461.0)  # inverse-depth step
    pi1: float = 16.0
    pi2: float = 64.0
    tau_so: float = 8.0
    sparse_ratio: float = 15.0
    tau2_scale: float = 0.05   # measurement variance per (inv-depth step)²
    min_frames: int = 2
    # per-pixel SGM penalty modulation from the reference image's texture
    # (`StereoMapper::InitReference`, `sgm_stereo_mapper.cpp:55-123`)
    use_penalty_map: bool = True
    # cost-volume storage dtype. bfloat16 halves the memory traffic of the
    # (H, W, D) volumes; sampling, AD and the WTA parabola run in fp32, and
    # the Bayes filter always runs fp32.
    dtype: str = "bfloat16"

    @property
    def jdtype(self):
        return jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32

    @property
    def inv_depths(self) -> np.ndarray:
        return (np.arange(self.num_depths, dtype=np.float32) + 1.0) * self.dep_sample


class DenseState(NamedTuple):
    """Per-reference-keyframe accumulation state (all device arrays)."""

    ref_img: jax.Array      # (H, W)
    grad: jax.Array         # (H, W) gradient magnitude of ref
    mean_cost: jax.Array    # (H, W, D) running-mean AD cost
    count: jax.Array        # (H, W, D) measurement counts
    sparse_bias: jax.Array | None  # (H, W, D) cost bias from sparse depths (None = no landmarks)
    penalty: jax.Array      # (H, W) per-pixel SGM penalty modulation
    filt: depth_filter.FilterState
    num_frames: jax.Array   # () int32


def init_reference(cfg: DenseConfig, ref_img: jax.Array,
                   sparse_uv: jax.Array | None = None,
                   sparse_inv_depth: jax.Array | None = None,
                   sparse_valid: jax.Array | None = None) -> DenseState:
    """Start a new reference keyframe (`DepthEstimator::Initialize` +
    `StereoMapper::InitReference`)."""
    h, w, d = cfg.height, cfg.width, cfg.num_depths
    dt = cfg.jdtype
    ref_img = ref_img.astype(jnp.float32)
    # No sparse landmarks -> bias is None (an empty pytree node), so
    # `fuse_measurement` skips the full-volume bias read+add entirely
    # instead of streaming a (H, W, D) zero volume from HBM every frame.
    bias = None
    if sparse_uv is not None:
        bias = splat_sparse(cfg, sparse_uv, sparse_inv_depth,
                            sparse_valid).astype(dt)
    grad = image_gradients(ref_img)
    penalty = (penalty_map(grad) if cfg.use_penalty_map
               else jnp.ones((h, w), jnp.float32))
    return DenseState(
        ref_img=ref_img,
        grad=grad,
        mean_cost=jnp.zeros((h, w, d), dt),
        count=jnp.zeros((h, w, d), dt),
        sparse_bias=bias,
        penalty=penalty,
        filt=depth_filter.init_state(h, w),
        num_frames=jnp.asarray(0, jnp.int32))


def penalty_map(grad: jax.Array) -> jax.Array:
    """Per-pixel SGM penalty modulation from reference-image texture.

    The reference computes `0.8 + 1.5 * mean(|grad|)^3 / (1 + |grad|^3)`
    (`StereoMapper::InitReference`, `sgm_stereo_mapper.cpp:75-82`), which is
    unbounded where |grad| ~ 0 (flat pixels get penalties of ~mean^3, 1e5+
    with its 5th-order Sobel) — harmless for its fp32 GPU volume but fatal
    for a bf16 cost volume, where a 1e5x penalty erases all photometric
    distinctions. We keep the same law in scale-free form,
    `0.8 + 1.5 / (1 + (|grad|/mean)^3)`, bounded to (0.8, 2.3]: uniform
    regions get ~2.3x stronger smoothing, textured regions approach 0.8x, so
    SGM trusts photometric cost exactly where the image can support it."""
    g = jnp.abs(grad.astype(jnp.float32))
    rel = g / jnp.maximum(jnp.mean(g), 1e-6)
    return (0.8 + 1.5 / (1.0 + rel ** 3)).astype(jnp.float32)


def splat_sparse(cfg: DenseConfig, uv: jax.Array, inv_depth: jax.Array,
                 valid: jax.Array, radius: int = 4) -> jax.Array:
    """Cost bias from sparse VIO landmarks: near each projected landmark, add
    `sparse_ratio * |d_hyp - d_sparse| / dep_sample * w(dist)` to the volume
    (`FuseSparseInfoKernel`, `calc_cost.cu:684-735`, splat
    `sgm_stereo_mapper.cpp:219-357`).

    uv: (P, 2) pixel coords in the reference image; inv_depth: (P,).
    """
    h, w, d = cfg.height, cfg.width, cfg.num_depths
    hyp = jnp.asarray(cfg.inv_depths)  # (D,)
    # nearest-pixel scatter of sparse inverse depths and weights
    n = h * w
    px = jnp.round(uv[:, 0]).astype(jnp.int32)
    py = jnp.round(uv[:, 1]).astype(jnp.int32)
    ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = jnp.where(ok, py * w + px, n)
    depth_map = jnp.zeros(n + 1, jnp.float32).at[flat].set(
        jnp.where(ok, inv_depth, 0.0))
    hit = jnp.zeros(n + 1, jnp.float32).at[flat].set(jnp.where(ok, 1.0, 0.0))
    depth_map = depth_map[:n].reshape(h, w)
    hit = hit[:n].reshape(h, w)
    # dilate the splat over a (2r+1)² window with inverse-distance weights
    acc_d = jnp.zeros((h, w), jnp.float32)
    acc_w = jnp.zeros((h, w), jnp.float32)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = 1.0 / (1.0 + np.hypot(dy, dx))
            shifted_d = jnp.roll(jnp.roll(depth_map, dy, 0), dx, 1)
            shifted_h = jnp.roll(jnp.roll(hit, dy, 0), dx, 1)
            acc_d = acc_d + shifted_d * shifted_h * wgt
            acc_w = acc_w + shifted_h * wgt
    mean_d = jnp.where(acc_w > 0, acc_d / jnp.maximum(acc_w, 1e-9), 0.0)
    bias = jnp.abs(hyp[None, None, :] - mean_d[..., None]) / cfg.dep_sample
    bias = bias * cfg.sparse_ratio * jnp.minimum(acc_w, 1.0)[..., None]
    return bias


@partial(jax.jit, static_argnums=0)
def fuse_measurement(cfg: DenseConfig, state: DenseState, meas_img: jax.Array,
                     a_mat: jax.Array, b_vec: jax.Array) -> DenseState:
    """Fuse one measurement frame (`FuseNewFrameSGM`, `depth_estimator.cpp:
    210-361`): cost slice -> running mean -> (bias + SGM + WTA) -> filter.

    a_mat = K_m R_mr K_r^-1, b_vec = K_m t_mr (reference-to-measurement).
    """
    inv_depths = jnp.asarray(cfg.inv_depths)
    c, v = costvolume.plane_sweep_cost(state.ref_img, meas_img.astype(jnp.float32),
                                       a_mat, b_vec, inv_depths,
                                       out_dtype=cfg.jdtype)
    mean_cost, count = costvolume.accumulate_cost(state.mean_cost, state.count, c, v)

    # SGM input: unobserved hypotheses get a high constant so they can't win
    observed = count > 0
    total = jnp.where(observed, mean_cost,
                      jnp.asarray(50.0, mean_cost.dtype))
    if state.sparse_bias is not None:
        total = total + state.sparse_bias
    inv_depth, conf = sgm.sgm_depth(total, state.grad.astype(total.dtype),
                                    inv_depths,
                                    valid_count=jnp.sum(observed, -1),
                                    min_count=cfg.num_depths * 0.25,
                                    pi1=cfg.pi1, pi2=cfg.pi2, tau_so=cfg.tau_so,
                                    penalty_scale=state.penalty)
    tau2 = jnp.full_like(inv_depth, (cfg.dep_sample ** 2) / cfg.tau2_scale)
    filt = depth_filter.update(state.filt, inv_depth, tau2, conf)
    return state._replace(mean_cost=mean_cost, count=count, filt=filt,
                          num_frames=state.num_frames + 1)


def finalize(cfg: DenseConfig, state: DenseState,
             ratio: float = 0.5) -> tuple[jax.Array, jax.Array]:
    """(inv_depth (H, W), valid (H, W)): converged-pixel mask, the
    reference's `FinalizeMapPoints` inlier-ratio < 0.5 rejection."""
    ok = depth_filter.converged_mask(state.filt, ratio)
    ok = ok & (state.num_frames >= cfg.min_frames)
    return state.filt.mu, ok


def propagate_reference(cfg: DenseConfig, prev: DenseState,
                        new_ref_img: jax.Array,
                        r_no: jax.Array, t_no: jax.Array,
                        k_mat: jax.Array,
                        sparse_bias: jax.Array | None = None) -> DenseState:
    """Start a new reference keyframe seeded from the previous one's filter
    state (`DepthEstimator::PropogateFromPreviousFrame`,
    `depth_estimator.cpp:610-635`): the old per-pixel Gaussian×Beta state is
    forward-warped through the relative transform old-cam -> new-cam, so
    depth knowledge survives reference switches instead of restarting cold.
    """
    st = init_reference(cfg, new_ref_img)
    filt = depth_filter.propagate(prev.filt, r_no, t_no, k_mat,
                                  jnp.linalg.inv(k_mat))
    if sparse_bias is not None:
        st = st._replace(sparse_bias=sparse_bias.astype(cfg.jdtype))
    return st._replace(filt=filt)


def regularize_depth(state: DenseState, strength: float = 1.0) -> DenseState:
    """Covariance-weighted 3×3 smoothing of the inverse-depth map
    (`DepthEstimator::RegularizeDepthMap`, `depth_estimator.cpp:696-758`):
    each pixel averages its neighborhood with weights 1/(sigma² + eps),
    pulled toward the center by `strength`; only converged-ish pixels vote.
    """
    mu, s2 = state.filt.mu, state.filt.sigma2
    w = 1.0 / (s2 + 1e-4)
    w = w * (state.filt.a / jnp.maximum(state.filt.a + state.filt.b, 1e-9))
    num = jnp.zeros_like(mu)
    den = jnp.zeros_like(mu)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            wgt = 1.0 if (dy, dx) == (0, 0) else strength / jnp.sqrt(
                jnp.asarray(float(dy * dy + dx * dx)))
            mu_s = jnp.roll(jnp.roll(mu, dy, 0), dx, 1)
            w_s = jnp.roll(jnp.roll(w, dy, 0), dx, 1) * wgt
            num = num + mu_s * w_s
            den = den + w_s
    mu_new = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9), mu)
    return state._replace(filt=state.filt._replace(mu=mu_new))


def validate_photometric(cfg: DenseConfig, state: DenseState,
                         meas_img: jax.Array, a_mat: jax.Array,
                         b_vec: jax.Array,
                         max_err: float = 20.0) -> jax.Array:
    """Photometric validation mask (`DepthEstimator::Validate`,
    `depth_estimator.cpp:639-691`): warp each reference pixel into the
    measurement frame at its *estimated* inverse depth and keep pixels whose
    absolute intensity error is below `max_err`.
    """
    from ..ops.image import bilinear_sample
    h, w = cfg.height, cfg.width
    u = jnp.arange(w, dtype=jnp.float32)
    v = jnp.arange(h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    base = jnp.einsum("ij,jhw->ihw", a_mat,
                      jnp.stack([uu, vv, jnp.ones_like(uu)]))
    p = base + b_vec[:, None, None] * state.filt.mu[None]
    z = jnp.where(jnp.abs(p[2]) > 1e-6, p[2], 1e-6)
    coords = jnp.stack([p[0] / z, p[1] / z], axis=-1)
    warped = bilinear_sample(meas_img.astype(jnp.float32), coords, fill=jnp.nan)
    err = jnp.abs(warped - state.ref_img)
    # a pixel whose warp lands OUTSIDE the measurement is unvalidatable,
    # not invalid — only in-view, photometrically-contradicted pixels are
    # rejected (the reference likewise skips out-of-view pixels,
    # `depth_estimator.cpp:663-668`)
    in_view = ((coords[..., 0] >= 0) & (coords[..., 0] <= w - 1)
               & (coords[..., 1] >= 0) & (coords[..., 1] <= h - 1))
    return ~in_view | (jnp.isfinite(err) & (err < max_err))
