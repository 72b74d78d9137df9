import numpy as np
import pytest

from cvids_tpu.io.multiagent import look_at
from cvids_tpu.mapping import mesh, tsdf


H, W = 60, 80
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


def render_sphere_depth(center, radius, r_wc, t_wc):
    """Ray-trace a sphere into a depth image for camera pose (r_wc, t_wc)."""
    kinv = np.linalg.inv(K)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    rays = np.stack([uu.ravel(), vv.ravel(), np.ones(H * W)], 0)
    rays = kinv @ rays
    rays /= np.linalg.norm(rays, axis=0, keepdims=True)
    d_w = r_wc @ rays  # ray directions in world
    o = t_wc
    oc = o - center
    b = 2 * d_w.T @ oc
    c = oc @ oc - radius ** 2
    disc = b ** 2 - 4 * c
    depth = np.full(H * W, np.nan)
    hit = disc > 0
    t_hit = (-b[hit] - np.sqrt(disc[hit])) / 2
    # depth = z-coordinate in camera frame = t_hit * rays_z_component... rays
    # normalized in cam frame: z component:
    z_dir = rays[2]
    depth[hit] = t_hit * z_dir[hit]
    depth[depth <= 0] = np.nan
    return depth.reshape(H, W)


@pytest.fixture(scope="module")
def sphere_volume():
    cfg = tsdf.TsdfConfig(voxel_size=0.05, capacity=2048, carving=True)
    vol = tsdf.TsdfVolume(cfg)
    center = np.array([0.0, 0.0, 1.0])
    radius = 0.4
    for ang in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        eye = center + 1.8 * np.array([np.cos(ang), np.sin(ang), 0.3])
        r_wc = look_at(eye, center)
        depth = render_sphere_depth(center, radius, r_wc, eye)
        depth = np.nan_to_num(depth, nan=0.0)
        color = np.full((H, W, 3), 128.0)
        vol.integrate(depth, color, K, r_wc.astype(np.float32),
                      eye.astype(np.float32))
    return vol, center, radius


def test_sdf_zero_on_surface(sphere_volume):
    vol, center, radius = sphere_volume
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(100, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # only directions seen by the cameras (equatorial band)
    dirs = dirs[np.abs(dirs[:, 2]) < 0.6]
    pts = center + dirs * radius
    sdf, wgt = vol.sdf_at(pts)
    seen = wgt > 0
    assert seen.mean() > 0.7
    assert np.abs(sdf[seen]).mean() < vol.cfg.voxel_size, np.abs(sdf[seen]).mean()


def test_sdf_sign_inside_outside(sphere_volume):
    vol, center, radius = sphere_volume
    out_pts = center + np.array([[radius + 0.08, 0, 0], [0, radius + 0.08, 0]])
    in_pts = center + np.array([[radius - 0.08, 0, 0], [0, radius - 0.08, 0]])
    sdf_o, w_o = vol.sdf_at(out_pts)
    sdf_i, w_i = vol.sdf_at(in_pts)
    assert (sdf_o[w_o > 0] > 0).all()
    assert (sdf_i[w_i > 0] < 0).all()


def test_mesh_on_sphere_surface(sphere_volume, tmp_path):
    vol, center, radius = sphere_volume
    verts, cols, norms = mesh.extract_mesh(vol)
    assert len(verts) > 200, len(verts)
    d = np.linalg.norm(verts.reshape(-1, 3) - center, axis=1)
    err = np.abs(d - radius)
    assert np.median(err) < vol.cfg.voxel_size, np.median(err)
    # vertex normals: unit length, outward (pointing away from the sphere
    # center — the SDF gradient direction; `ChunkManager.cpp:259-296`)
    nf = norms.reshape(-1, 3)
    np.testing.assert_allclose(np.linalg.norm(nf, axis=1), 1.0, atol=1e-4)
    radial = verts.reshape(-1, 3) - center
    radial /= np.maximum(np.linalg.norm(radial, axis=1, keepdims=True), 1e-9)
    cosang = np.sum(nf * radial, axis=1)
    assert np.median(cosang) > 0.9, np.median(cosang)
    # PLY round trip (positions + normals)
    p = str(tmp_path / "sphere.ply")
    mesh.write_ply(p, verts, cols, norms)
    v2, t, n2 = mesh.read_ply(p)
    assert t == len(verts)
    np.testing.assert_allclose(v2, verts.reshape(-1, 3), atol=1e-6)
    np.testing.assert_allclose(n2, nf, atol=1e-6)


def test_carving_removes_floaters():
    cfg = tsdf.TsdfConfig(voxel_size=0.05, capacity=1024, carving=True,
                          carve_weight=1.0)
    vol = tsdf.TsdfVolume(cfg)
    center = np.array([0.0, 0.0, 1.0])
    eye = center + np.array([1.5, 0.0, 0.0])
    r_wc = look_at(eye, center)
    # first frame: phantom sphere
    depth1 = render_sphere_depth(center, 0.3, r_wc, eye)
    vol.integrate(np.nan_to_num(depth1, nan=0.0), np.zeros((H, W, 3)), K,
                  r_wc.astype(np.float32), eye.astype(np.float32))
    sdf0, w0 = vol.sdf_at(center[None] + [[0.3, 0, 0]])
    assert w0[0] > 0
    # many later frames: wall far behind -> phantom surface gets carved
    flat = np.full((H, W), 2.5)
    for _ in range(5):
        vol.integrate(flat, np.zeros((H, W, 3)), K,
                      r_wc.astype(np.float32), eye.astype(np.float32))
    sdf1, w1 = vol.sdf_at(center[None] + [[0.3, 0, 0]])
    assert w1[0] < w0[0]


def test_chunk_pool_grows_past_initial_capacity():
    """A small initial pool tier-doubles instead of silently dropping chunks
    (the reference's chunk map grows unbounded, `ChunkManager.h:40-55`)."""
    cfg = tsdf.TsdfConfig(voxel_size=0.05, capacity=16)
    vol = tsdf.TsdfVolume(cfg)
    depth = np.full((H, W), 1.0)
    vol.integrate(depth, np.zeros((H, W, 3)), K, np.eye(3, dtype=np.float32),
                  np.zeros(3, np.float32))
    assert len(vol.slot_of) > 16          # really needed more than one tier
    assert vol.capacity >= len(vol.slot_of)
    assert vol.pool.sdf.shape[0] == vol.capacity
    assert vol.dropped_chunks == 0
    # the grown pool still integrates correctly: surface voxel gets weight
    sdf, w = vol.sdf_at(np.array([[0.0, 0.0, 1.0]]))
    assert w[0] > 0


def test_chunk_pool_max_capacity_counts_drops():
    cfg = tsdf.TsdfConfig(voxel_size=0.05, capacity=16, max_capacity=16)
    vol = tsdf.TsdfVolume(cfg)
    depth = np.full((H, W), 1.0)
    vol.integrate(depth, np.zeros((H, W, 3)), K, np.eye(3, dtype=np.float32),
                  np.zeros(3, np.float32))
    assert vol.capacity == 16
    assert len(vol.slot_of) <= 16
    assert vol.dropped_chunks > 0         # loss is visible, not silent


def test_point_cloud_fusion_mode():
    """chisel_ros's PointCloud fusion mode (`ChiselNode.cpp:54-77` mode
    switch; raycast integrator `ProjectionIntegrator.cpp:52-173`): points on
    a known plane integrate into a zero crossing at the plane, carving
    clears free space, and the mesh extractor finds the surface."""
    import numpy as np

    from cvids_tpu.mapping import tsdf
    from cvids_tpu.mapping.mesh import extract_mesh

    cfg = tsdf.TsdfConfig(voxel_size=0.1, capacity=512, carving=True,
                          min_depth=0.3, max_depth=10.0)
    vol = tsdf.TsdfVolume(cfg)
    rng = np.random.default_rng(0)
    origin = np.array([0.0, 0.0, 1.0])
    # points on the plane z = 0 in front of/below the sensor
    pts = np.stack([rng.uniform(-1.0, 1.0, 4000),
                    rng.uniform(-1.0, 1.0, 4000),
                    np.zeros(4000)], -1)
    cols = np.full((4000, 3), 128.0)
    for _ in range(3):
        vol.integrate_points(pts, cols, origin)

    # SDF straddles the plane: positive above (toward the sensor), negative
    # below (behind the surface)
    probe_above = np.stack([rng.uniform(-0.5, 0.5, 64),
                            rng.uniform(-0.5, 0.5, 64),
                            np.full(64, 0.15)], -1)
    probe_below = probe_above - np.array([0, 0, 0.3])
    s_above, w_above = vol.sdf_at(probe_above)
    s_below, w_below = vol.sdf_at(probe_below)
    seen_a = w_above > 0
    seen_b = w_below > 0
    assert seen_a.mean() > 0.5 and seen_b.mean() > 0.3
    assert np.median(s_above[seen_a]) > 0.0
    assert np.median(s_below[seen_b]) < 0.0

    # carving decremented weights along the free-space rays well above the
    # band: integrate a later observation that moved (dynamic object) and
    # verify free space isn't solid
    verts, _, _ = extract_mesh(vol)
    assert len(verts) > 50, "no surface extracted from point fusion"
    z = np.asarray(verts, np.float64).reshape(-1, 3)[:, 2]
    assert abs(float(np.median(z))) < 0.08, float(np.median(z))
