import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvids_tpu.dense import estimator
from cvids_tpu.ops import costvolume, depth_filter, sgm
from cvids_tpu.ops.image import gaussian_blur


H, W, D = 48, 64, 32


def cam_k(f=40.0):
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def textured_plane_views(rng, depth=2.0, baselines=(0.1,)):
    """Fronto-parallel textured plane seen from a reference camera and
    several baseline-shifted measurement cameras (pure x-translation).

    Camera moved +x by b: point (x, y, Z) lands at u_m = u_r - f*b/Z, so
    I_m(u) = I_r(u + disp), disp = f*b/Z.
    """
    k = cam_k()
    pad = 40
    tex = rng.uniform(0, 255, (H, W + 2 * pad)).astype(np.float32)
    tex = np.asarray(gaussian_blur(jnp.asarray(tex), 1.5))
    ref = tex[:, pad:pad + W]
    views = []
    for b in baselines:
        disp = k[0, 0] * b / depth
        shift = int(round(disp))
        meas = tex[:, pad + shift:pad + shift + W]
        t = np.array([-b, 0.0, 0.0], np.float32)
        a_mat = (k @ np.linalg.inv(k)).astype(np.float32)
        b_vec = (k @ t).astype(np.float32)
        views.append((meas, a_mat, b_vec))
    return ref, views, k


def textured_plane_pair(rng, depth=2.0, baseline=0.1):
    ref, views, k = textured_plane_views(rng, depth, (baseline,))
    meas, a_mat, b_vec = views[0]
    return ref, meas, a_mat, b_vec, k


def inv_depth_grid(depth_min=0.8, depth_max=8.0):
    inv = np.linspace(1.0 / depth_max, 1.0 / depth_min, D).astype(np.float32)
    return inv


def test_cost_volume_minimum_at_true_depth(rng):
    depth = 2.0
    ref, meas, a_mat, b_vec, k = textured_plane_pair(rng, depth=depth)
    inv = inv_depth_grid()
    cost, valid = costvolume.plane_sweep_cost(
        jnp.asarray(ref), jnp.asarray(meas), jnp.asarray(a_mat),
        jnp.asarray(b_vec), jnp.asarray(inv))
    c = np.asarray(cost)
    v = np.asarray(valid)
    # central crop (borders suffer from warping out of view)
    crop = (slice(10, -10), slice(10, -10))
    best = np.argmin(np.where(v, c, np.inf), axis=-1)[crop]
    est_inv = inv[best]
    med = np.median(1.0 / est_inv)
    assert abs(med - depth) < 0.25, med


def test_accumulate_cost_running_mean(rng):
    c1 = jnp.asarray(rng.uniform(0, 1, (4, 4, 8)).astype(np.float32))
    c2 = jnp.asarray(rng.uniform(0, 1, (4, 4, 8)).astype(np.float32))
    v = jnp.ones((4, 4, 8), bool)
    m, n = costvolume.accumulate_cost(jnp.zeros((4, 4, 8)), jnp.zeros((4, 4, 8)), c1, v)
    m, n = costvolume.accumulate_cost(m, n, c2, v)
    np.testing.assert_allclose(np.asarray(m), np.asarray((c1 + c2) / 2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(n), 2.0)
    # invalid second sample leaves mean unchanged
    m2, n2 = costvolume.accumulate_cost(m, n, c1 * 100, jnp.zeros((4, 4, 8), bool))
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m))


def test_sgm_denoises_wta(rng):
    # true disparity plane = constant index 12, noisy unary costs
    true_idx = 12
    base = rng.uniform(0.4, 0.6, (H, W, D)).astype(np.float32)
    base[..., true_idx] -= 0.25
    noise = rng.normal(0, 0.15, (H, W, D)).astype(np.float32)
    noisy = base + noise
    raw_idx = np.argmin(noisy, -1)
    raw_acc = (raw_idx == true_idx).mean()
    agg = sgm.sgm_aggregate(jnp.asarray(noisy), jnp.zeros((H, W)), pi1=0.5, pi2=2.0)
    sgm_idx = np.argmin(np.asarray(agg), -1)
    sgm_acc = (sgm_idx == true_idx).mean()
    assert sgm_acc > raw_acc + 0.2, (raw_acc, sgm_acc)
    assert sgm_acc > 0.95


def test_wta_subpixel_and_peak_rejection():
    d = 16
    cost = np.ones((2, 2, d), np.float32)
    # pixel (0,0): sharp parabola with min between 5 and 6
    cost[0, 0] = 1.0
    idxs = np.arange(d)
    cost[0, 0] = 0.1 * (idxs - 5.3) ** 2
    # pixel (0,1): flat (ambiguous) -> rejected
    cost[0, 1] = 1.0
    idx_f, conf = sgm.wta_depth(jnp.asarray(cost))
    assert abs(float(idx_f[0, 0]) - 5.3) < 0.1
    assert bool(conf[0, 0])
    assert not bool(conf[0, 1])


def test_depth_filter_converges(rng):
    st = depth_filter.init_state(4, 4)
    true = 0.5 * jnp.ones((4, 4))
    for _ in range(30):
        x = true + jnp.asarray(rng.normal(0, 0.05, (4, 4)).astype(np.float32))
        st = depth_filter.update(st, x, jnp.full((4, 4), 0.05 ** 2), jnp.ones((4, 4), bool))
    np.testing.assert_allclose(np.asarray(st.mu), 0.5, atol=0.05)
    assert np.asarray(depth_filter.converged_mask(st)).all()
    assert (np.asarray(st.sigma2) < 1e-3).all()


def test_depth_filter_rejects_outliers(rng):
    st = depth_filter.init_state(2, 2)
    # consistent inliers at 0.5 mixed with uniform junk
    for i in range(40):
        if i % 3 == 0:
            x = jnp.asarray(rng.uniform(0.01, 5.0, (2, 2)).astype(np.float32))
        else:
            x = 0.5 + jnp.asarray(rng.normal(0, 0.03, (2, 2)).astype(np.float32))
        st = depth_filter.update(st, x, jnp.full((2, 2), 0.03 ** 2), jnp.ones((2, 2), bool))
    np.testing.assert_allclose(np.asarray(st.mu), 0.5, atol=0.1)


def test_depth_filter_propagate_identity():
    st = depth_filter.init_state(8, 8, mu0=0.5, sigma2_0=0.01, a0=20, b0=2)
    k = jnp.asarray(cam_k(10.0))
    out = depth_filter.propagate(st, jnp.eye(3), jnp.zeros(3), k, jnp.linalg.inv(k))
    np.testing.assert_allclose(np.asarray(out.mu), 0.5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.a), 20, atol=1e-4)


def test_dense_pipeline_end_to_end(rng):
    depth = 2.0
    cfg = estimator.DenseConfig(height=H, width=W, num_depths=D,
                                dep_sample=float(inv_depth_grid()[1] - inv_depth_grid()[0]),
                                tau2_scale=0.5, pi1=2.0, pi2=8.0)
    # override hypothesis grid start by monkeypatching via dep offsets: the
    # config grid starts at dep_sample; build geometry so truth is in range.
    inv = cfg.inv_depths
    assert inv[0] < 1.0 / depth < inv[-1]
    ref, views, k = textured_plane_views(rng, depth=depth,
                                         baselines=(0.1, 0.15, 0.2))
    st = estimator.init_reference(cfg, jnp.asarray(ref))
    for meas, a_mat, b_vec in views:
        st = estimator.fuse_measurement(cfg, st, jnp.asarray(meas),
                                        jnp.asarray(a_mat), jnp.asarray(b_vec))
    inv_d, ok = estimator.finalize(cfg, st)
    crop = (slice(10, -10), slice(10, -10))
    okc = np.asarray(ok)[crop]
    est = 1.0 / np.maximum(np.asarray(inv_d)[crop], 1e-6)
    assert okc.mean() > 0.5, okc.mean()
    med = np.median(est[okc])
    assert abs(med - depth) < 0.3, med


def test_propagate_reference_carries_depth(rng):
    cfg = estimator.DenseConfig(height=H, width=W, num_depths=D,
                                dep_sample=float(inv_depth_grid()[1] - inv_depth_grid()[0]))
    ref, views, k = textured_plane_views(rng, depth=2.0, baselines=(0.1, 0.15, 0.2))
    st = estimator.init_reference(cfg, jnp.asarray(ref))
    for meas, a_mat, b_vec in views:
        st = estimator.fuse_measurement(cfg, st, jnp.asarray(meas),
                                        jnp.asarray(a_mat), jnp.asarray(b_vec))
    # new reference = same camera (identity transform): filter state carries
    st2 = estimator.propagate_reference(cfg, st, jnp.asarray(ref),
                                        jnp.eye(3), jnp.zeros(3),
                                        jnp.asarray(k, jnp.float32))
    crop = (slice(12, -12), slice(12, -12))
    mu_err = np.abs(np.asarray(st2.filt.mu) - np.asarray(st.filt.mu))[crop]
    assert np.median(mu_err) < 0.02
    assert int(st2.num_frames) == 0  # fresh accumulation


def test_regularize_smooths_outlier_pixels(rng):
    cfg = estimator.DenseConfig(height=16, width=16, num_depths=8)
    st = estimator.init_reference(cfg, jnp.zeros((16, 16)))
    mu = jnp.full((16, 16), 0.5).at[8, 8].set(3.0)
    s2 = jnp.full((16, 16), 1e-3).at[8, 8].set(10.0)  # outlier is uncertain
    filt = st.filt._replace(mu=mu, sigma2=s2, a=jnp.full((16, 16), 20.0),
                            b=jnp.full((16, 16), 2.0))
    st = st._replace(filt=filt)
    out = estimator.regularize_depth(st)
    assert abs(float(out.filt.mu[8, 8]) - 0.5) < 0.1  # pulled to neighbors


def test_validate_photometric(rng):
    depth = 2.0
    cfg = estimator.DenseConfig(height=H, width=W, num_depths=D,
                                dep_sample=float(inv_depth_grid()[1] - inv_depth_grid()[0]))
    ref, meas, a_mat, b_vec, k = textured_plane_pair(rng, depth=depth)
    st = estimator.init_reference(cfg, jnp.asarray(ref))
    # correct depth -> photometric check passes
    st = st._replace(filt=st.filt._replace(mu=jnp.full((H, W), 1.0 / depth)))
    ok = estimator.validate_photometric(cfg, st, jnp.asarray(meas),
                                        jnp.asarray(a_mat), jnp.asarray(b_vec),
                                        max_err=8.0)
    crop = (slice(8, -8), slice(8, -8))
    assert np.asarray(ok)[crop].mean() > 0.9
    # badly wrong depth (several px of disparity error) -> mostly fails
    st_bad = st._replace(filt=st.filt._replace(mu=jnp.full((H, W), 1.0 / 0.5)))
    ok_bad = estimator.validate_photometric(cfg, st_bad, jnp.asarray(meas),
                                            jnp.asarray(a_mat),
                                            jnp.asarray(b_vec), max_err=8.0)
    assert np.asarray(ok_bad)[crop].mean() < np.asarray(ok)[crop].mean() - 0.2


def test_mxu_sweep_matches_gather_oracle(rng):
    """The production (gather) plane sweep must match the banded-matmul
    formulation (`banded_sweep`): identically for pure-translation geometry,
    and within interpolation-path tolerance once that formulation's
    projective pre-alignment is active (two-pass resampling samples along
    the warped scanline; on smooth images the difference is
    sub-intensity-level)."""
    from banded_sweep import plane_sweep_cost_banded

    def angax(ax, a):
        c, s = np.cos(a), np.sin(a)
        if ax == 0:
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    k = cam_k()
    inv = jnp.asarray(inv_depth_grid())
    ref = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32), 1.5)
    meas = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32), 1.5)

    # identity rotation: formulations agree essentially exactly
    a_mat = jnp.asarray(k @ np.linalg.inv(k))
    b_vec = jnp.asarray(k @ np.array([-0.1, 0.02, 0.01], np.float32))
    c1, v1 = plane_sweep_cost_banded(ref, meas, a_mat, b_vec, inv)
    c2, v2 = costvolume.plane_sweep_cost(ref, meas, a_mat, b_vec, inv)
    both = np.asarray(v1) & np.asarray(v2)
    assert both.mean() > 0.7
    assert (np.asarray(v1) == np.asarray(v2)).mean() > 0.98
    assert np.abs(np.asarray(c1) - np.asarray(c2))[both].max() < 0.5

    # rotated geometry: smooth-image tolerance
    r21 = angax(0, 0.03) @ angax(1, -0.05)
    a_mat = jnp.asarray(k @ r21 @ np.linalg.inv(k))
    b_vec = jnp.asarray(k @ np.array([0.15, -0.05, 0.03], np.float32))
    c1, v1 = plane_sweep_cost_banded(ref, meas, a_mat, b_vec, inv)
    c2, v2 = costvolume.plane_sweep_cost(ref, meas, a_mat, b_vec, inv)
    both = np.asarray(v1) & np.asarray(v2)
    assert both.mean() > 0.5
    err = np.abs(np.asarray(c1) - np.asarray(c2))[both]
    assert err.mean() < 1.0 and np.median(err) < 0.5


def test_sparse_bias_improves_ambiguous_depth(rng):
    """VERDICT item 4 'done' criterion: the sparse VIO prior must measurably
    improve depth where photometric evidence is weak (`FuseSparseInfoKernel`,
    `calc_cost.cu:684-735`). A near-textureless plane makes the cost volume
    almost flat; splatted sparse depths should pull SGM/WTA to the truth."""
    depth = 2.0
    cfg = estimator.DenseConfig(
        height=H, width=W, num_depths=D,
        dep_sample=float(inv_depth_grid()[1] - inv_depth_grid()[0]),
        tau2_scale=0.5, pi1=2.0, pi2=8.0)
    inv_true = 1.0 / depth
    k = cam_k()
    pad = 40
    # texture amplitude ~2 gray levels + sensor noise -> ambiguous matching
    tex = 100.0 + rng.uniform(0, 2.0, (H, W + 2 * pad)).astype(np.float32)
    ref = tex[:, pad:pad + W]
    views = []
    for b in (0.1, 0.15, 0.2):
        disp = int(round(k[0, 0] * b / depth))
        meas = tex[:, pad + disp:pad + disp + W]
        meas = meas + rng.normal(0, 0.5, meas.shape).astype(np.float32)
        views.append((meas, (k @ np.linalg.inv(k)).astype(np.float32),
                      (k @ np.array([-b, 0, 0], np.float32)).astype(np.float32)))

    # sparse prior: a grid of correct-depth landmarks every ~8 px
    gy, gx = np.mgrid[4:H - 4:8, 4:W - 4:8]
    uv = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    sp_inv = np.full(len(uv), inv_true, np.float32)

    def run(sparse):
        if sparse:
            st = estimator.init_reference(
                cfg, jnp.asarray(ref), sparse_uv=jnp.asarray(uv),
                sparse_inv_depth=jnp.asarray(sp_inv),
                sparse_valid=jnp.ones(len(uv), bool))
        else:
            st = estimator.init_reference(cfg, jnp.asarray(ref))
        for meas, a_mat, b_vec in views:
            st = estimator.fuse_measurement(cfg, st, jnp.asarray(meas),
                                            jnp.asarray(a_mat),
                                            jnp.asarray(b_vec))
        crop = (slice(8, -8), slice(8, -8))
        err = np.abs(np.asarray(st.filt.mu) - inv_true)[crop]
        return np.sqrt(np.mean(err ** 2))

    rms_off = run(False)
    rms_on = run(True)
    assert rms_on < 0.6 * rms_off, (rms_on, rms_off)
    assert rms_on < 0.05, rms_on


def test_penalty_map_modulates_by_texture(rng):
    """`InitReference` penalty map (`sgm_stereo_mapper.cpp:75-82`): smooth
    regions get stronger SGM penalties (up to 0.8 + 1.5*mean^3), textured
    regions approach the 0.8 floor."""
    img = np.full((H, W), 50.0, np.float32)
    img[:, W // 2:] += rng.uniform(0, 120.0, (H, W // 2)).astype(np.float32)
    from cvids_tpu.ops.image import image_gradients
    pm = np.asarray(estimator.penalty_map(image_gradients(jnp.asarray(img))))
    flat = pm[4:-4, 4:W // 2 - 4].mean()
    busy = pm[4:-4, W // 2 + 4:-4].mean()
    assert flat > 2.0, flat           # near the 2.3 ceiling
    assert busy < 1.4, busy
    assert pm.min() >= 0.8 - 1e-5 and pm.max() <= 2.3 + 1e-5
    # a fresh reference state carries the map; disabling yields ones
    st = estimator.init_reference(cfg := estimator.DenseConfig(
        height=H, width=W, num_depths=8), jnp.asarray(img))
    assert st.penalty.shape == (H, W)
    cfg_off = estimator.DenseConfig(height=H, width=W, num_depths=8,
                                    use_penalty_map=False)
    st_off = estimator.init_reference(cfg_off, jnp.asarray(img))
    np.testing.assert_array_equal(np.asarray(st_off.penalty), 1.0)
