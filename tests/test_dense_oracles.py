"""Dense-path operations against independent references: the plane sweep
against the banded-matmul formulation, SGM, WTA and the depth filter against
plain numpy, and the SGM GPU kernel (interpret mode) against `lax.scan`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from banded_sweep import plane_sweep_cost_banded
from cvids_tpu.ops import costvolume, depth_filter, sgm
from cvids_tpu.ops.image import gaussian_blur
from cvids_tpu.ops.sgm_triton import sgm_scan_bidir

H, W, D = 48, 64, 32


def _rot(ax, a):
    c, s = np.cos(a), np.sin(a)
    if ax == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


GEOMETRY = {
    # (rotation, translation, least jointly valid share): pure translation,
    # a rotated pair, and a 1 m move along the optical axis that puts the
    # nearest planes behind the measurement camera
    "identity": (np.eye(3, dtype=np.float32), [-0.1, 0.02, 0.01], 0.7),
    "rotated": (_rot(0, 0.03) @ _rot(1, -0.05), [0.15, -0.05, 0.03], 0.5),
    "behind": (np.eye(3, dtype=np.float32), [0.05, 0.0, -1.0], 0.15),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
def test_sweep_matches_banded_oracle(rng, geometry, dtype):
    k = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    r21, t21, overlap = GEOMETRY[geometry]
    a_mat = jnp.asarray(k @ r21 @ np.linalg.inv(k))
    b_vec = jnp.asarray(k @ np.asarray(t21, np.float32))
    inv = jnp.asarray(np.linspace(1.0 / 8.0, 1.0 / 0.8, D), jnp.float32)
    ref = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32), 1.5)
    meas = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32), 1.5)

    c, v = costvolume.plane_sweep_cost(ref, meas, a_mat, b_vec, inv,
                                       out_dtype=jnp.dtype(dtype))
    assert c.dtype == jnp.dtype(dtype) and c.shape == (H, W, D)
    c_o, v_o = plane_sweep_cost_banded(ref, meas, a_mat, b_vec, inv)
    v, v_o = np.asarray(v), np.asarray(v_o)
    both = v & v_o
    err = np.abs(np.asarray(c, np.float32) - np.asarray(c_o))[both]
    # bf16 stores the cost with 8 significant bits: half an ulp of the
    # largest patch costs here (< 64) is 0.125
    quant = 0.125 if dtype == "bfloat16" else 0.0
    assert both.mean() > overlap
    if geometry == "rotated":
        # the oracle pre-warps in two resampling passes, the sweep samples
        # once: sub-intensity differences on smooth images
        assert err.mean() < 1.0 + quant and np.median(err) < 0.5 + quant
    else:
        assert (v == v_o).mean() > 0.98
        assert err.max() < 0.5 + quant
    if geometry == "behind":
        # planes with 1 + t_z rho <= 0 lie behind the measurement camera
        behind = 1.0 - np.asarray(inv) <= 0.0
        assert behind.any() and not v[..., behind].any()


def _sgm_numpy(cost, p1, p2):
    """Forward + backward SGM recurrence along axis 0 of (S, X, D), fp64."""
    def run(c, p):
        out = np.empty_like(c)
        out[0] = c[0]
        for s in range(1, len(c)):
            prev = out[s - 1]
            lo = np.concatenate([np.full_like(prev[:, :1], np.inf), prev[:, :-1]], 1)
            hi = np.concatenate([prev[:, 1:], np.full_like(prev[:, :1], np.inf)], 1)
            m = prev.min(-1, keepdims=True)
            out[s] = c[s] + np.minimum(prev, np.minimum(np.minimum(lo, hi) + p1,
                                                         m + p[s][:, None])) - m
        return out
    return run(cost, p2) + run(cost[::-1], p2[::-1])[::-1]


@pytest.mark.parametrize("length", [45, 48])
def test_scan_bidir_matches_numpy(rng, length):
    cost = rng.uniform(0, 50, (length, 12, 32))
    p2 = rng.uniform(30, 70, (length, 12))
    out = sgm._scan_bidir(jnp.asarray(cost, jnp.float32), jnp.asarray(16.0),
                          jnp.asarray(p2, jnp.float32))
    ref = _sgm_numpy(cost, 16.0, p2)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("axis,shape", [
    (0, (48, 16, 128)), (1, (45, 16, 128)), (0, (12, 10, 48))])
def test_sgm_kernel_interpret_matches_scan(rng, axis, shape):
    """The GPU kernel, run by the Pallas interpreter, equals the lax.scan
    form bit for bit in fp32: scan axis 0 and 1, an odd scan length, and a
    depth count (48) that the wrapper pads to 64."""
    cost = jnp.asarray(rng.uniform(0, 50, shape), jnp.float32)
    p2 = jnp.asarray(rng.uniform(30, 70, shape[:2]), jnp.float32)
    p1 = jnp.asarray(16.0)
    out = sgm_scan_bidir(cost, p2, p1, axis=axis, interpret=True)
    assert out.shape == shape
    if axis == 0:
        ref = sgm._scan_bidir(cost, p1, p2)
    else:
        ref = jnp.swapaxes(sgm._scan_bidir(jnp.swapaxes(cost, 0, 1), p1, p2.T), 0, 1)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_sgm_kernel_vmap(rng):
    """Batched over agents (the sharded dense path vmaps the fuse step) the
    kernel still matches the lax.scan form."""
    cost = jnp.asarray(rng.uniform(0, 50, (2, 8, 12, 16)), jnp.float32)
    p2 = jnp.asarray(rng.uniform(30, 70, (2, 8, 12)), jnp.float32)
    p1 = jnp.asarray(16.0)
    out = jax.vmap(lambda c, p: sgm_scan_bidir(c, p, p1, axis=1,
                                               interpret=True))(cost, p2)
    ref = jax.vmap(lambda c, p: sgm.scan_pair(c, p, p1, axis=1))(cost, p2)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def _wta_numpy(cost, peak_ratio=0.98):
    d = cost.shape[-1]
    idx = np.argmin(cost, -1)
    c0 = np.take_along_axis(cost, idx[..., None], -1)[..., 0]
    cm = np.take_along_axis(cost, np.clip(idx - 1, 0, d - 1)[..., None], -1)[..., 0]
    cp = np.take_along_axis(cost, np.clip(idx + 1, 0, d - 1)[..., None], -1)[..., 0]
    denom = cm + cp - 2 * c0
    delta = np.where(denom > 1e-6, 0.5 * (cm - cp) / np.maximum(denom, 1e-6), 0.0)
    idx_f = idx + np.clip(delta, -1.0, 1.0)
    masked = np.where(np.abs(np.arange(d) - idx[..., None]) <= 1, np.inf, cost)
    conf = (c0 < peak_ratio * masked.min(-1)) & (idx > 0) & (idx < d - 1)
    return idx_f, conf


def test_wta_depth_matches_numpy(rng):
    h, w, d = 16, 32, 128
    cost = rng.uniform(0, 100, (h, w, d)).astype(np.float32)
    cost[0, 0, :] = 15.0                 # all tied: argmin takes the first
    cost[1, 1, 3] = cost[1, 1, 90] = -60  # tie between two separate minima
    cost[2, 2, 0] = -100.0               # minimum at a boundary index ->
    cost[3, 3, d - 1] = -100.0           # never confident
    idx_f, conf = sgm.wta_depth(jnp.asarray(cost))
    ref_idx, ref_conf = _wta_numpy(cost)
    np.testing.assert_allclose(np.asarray(idx_f), ref_idx, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(conf), ref_conf)
    assert float(idx_f[0, 0]) == 0.0 and int(round(float(idx_f[1, 1]))) == 3
    assert not conf[2, 2] and not conf[3, 3]


def test_depth_filter_update_matches_numpy(rng):
    h, w = 13, 150
    mu = rng.uniform(0.2, 1.0, (h, w))
    s2 = rng.uniform(0.01, 1.0, (h, w))
    a = rng.uniform(5, 30, (h, w))
    b = rng.uniform(5, 30, (h, w))
    x = rng.uniform(0.1, 1.5, (h, w))
    x[0, 0] = 500.0                       # out of range: only b may move
    tau2 = np.full((h, w), 0.01)
    valid = np.ones((h, w), bool)
    valid[1, 1] = False
    st = depth_filter.FilterState(*[jnp.asarray(v, jnp.float32) for v in (mu, s2, a, b)])
    out = depth_filter.update(st, jnp.asarray(x, jnp.float32),
                              jnp.asarray(tau2, jnp.float32), jnp.asarray(valid))

    # Vogiatzis & Hernandez 2011, eqs. 19-26, in float64
    s = 1.0 / (1.0 / s2 + 1.0 / tau2)
    m = s * (mu / s2 + x / tau2)
    var = s2 + tau2
    c1 = a / (a + b) * np.exp(-0.5 * (x - mu) ** 2 / var) / np.sqrt(2 * np.pi * var)
    c2 = b / (a + b) / (100.0 - 0.01)
    c1, c2 = c1 / (c1 + c2), c2 / (c1 + c2)
    f = c1 * (a + 1) / (a + b + 1) + c2 * a / (a + b + 1)
    e = (c1 * (a + 1) * (a + 2) + c2 * a * (a + 1)) / ((a + b + 1) * (a + b + 2))
    mu_n = c1 * m + c2 * mu
    s2_n = c1 * (s + m * m) + c2 * (s2 + mu * mu) - mu_n ** 2
    a_n = (e - f) / (f - e / f)
    b_n = a_n * (1 - f) / f
    skip = (x < 0.01) | (x > 100.0) | ~valid
    ref = (np.where(skip, mu, mu_n), np.where(skip, s2, s2_n),
           np.where(skip, a, a_n), np.where(skip, np.where(valid, b + 1, b), b_n))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np.asarray(o), r, rtol=2e-4, atol=1e-5)
    assert float(out.b[0, 0]) == pytest.approx(b[0, 0] + 1, rel=1e-6)
    assert float(out.b[1, 1]) == pytest.approx(b[1, 1], rel=1e-6)
