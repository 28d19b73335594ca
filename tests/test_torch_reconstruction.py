"""The port's numpy copies in ``reconstruction/`` (the GeoFusion dataset,
point clouds, the interactive viewer, headless plots) and the
``/visualizer`` route of its REST service, against the JAX package's
modules on the same inputs: the cases of ``tests/test_reconstruction.py``
and ``tests/test_interactive_viewer.py``, each result equal to JAX's bit
for bit (the same numpy code; the viewer's HTML and the written files byte
for byte).
"""

import urllib.request

import numpy as np
import pytest

from deepearth_tpu import reconstruction as jrec
from deepearth_tpu.serving import DashboardServer as JaxServer
from deepearth_tpu.serving import DataService as JaxService
from deepearth_tpu_torch import reconstruction as trec
from deepearth_tpu_torch.serving import DashboardServer, DataService

INTRINSICS = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
POSES_CSV = (
    "time,image,latitude,longitude,altitude,yaw,pitch,roll,"
    "xyAccuracy,zAccuracy\n"
    "1.0,f1,28.50,-81.40,30.0,0.0,0.0,0.0,0.01,0.02\n"
    "2.0,f2,28.51,-81.41,31.0,90.0,0.0,0.0,0.01,0.02\n"
)


def both(name):
    return getattr(jrec, name), getattr(trec, name)


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def depth_cases():
    rng = np.random.default_rng(0)
    center = np.zeros((48, 64), np.float32)
    center[24, 32] = 5.0
    mixed = np.full((48, 64), -1.0, np.float32)
    mixed[0, 0], mixed[1, 1] = 2.0, 100.0
    return {"center": (center, {}),
            "max_depth": (mixed, {"max_depth": 50.0}),
            "random_stride": (rng.uniform(-1, 20, (48, 64)).astype(np.float32),
                              {"stride": 3, "max_depth": 15.0})}


@pytest.mark.parametrize("case", list(depth_cases()))
def test_unproject_and_world_cloud_match_jax(case):
    depth, kw = depth_cases()[case]
    (jun, tun), (jw, tw) = both("unproject_depth"), both("depth_to_world_cloud")
    jk, tk = (m.CameraIntrinsics(**INTRINSICS) for m in (jrec, trec))
    equal(tun(depth, tk, **kw), jun(depth, jk, **kw))
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    t = np.array([10.0, 20.0, 30.0])
    equal(tw(depth, tk, R, t, **kw), jw(depth, jk, R, t, **kw))
    equal(trec.transform_points(depth[:5, :3].astype(np.float64), R, t),
          jrec.transform_points(depth[:5, :3].astype(np.float64), R, t))
    equal(tk.matrix, jk.matrix)


def test_voxel_downsample_and_ply_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3))
    equal(trec.voxel_downsample(pts, 0.5), jrec.voxel_downsample(pts, 0.5))
    cols = (rng.random((300, 3)) * 255).astype(np.uint8)
    for colors in (cols, None):
        trec.save_ply(str(tmp_path / "t.ply"), pts, colors)
        jrec.save_ply(str(tmp_path / "j.ply"), pts, colors)
        assert ((tmp_path / "t.ply").read_bytes()
                == (tmp_path / "j.ply").read_bytes())
        (tp, tc), (jp, jc) = (m.load_ply(str(tmp_path / "j.ply"))
                              for m in (trec, jrec))
        equal(tp, jp)
        if colors is None:
            assert tc is None and jc is None
        else:
            equal(tc, jc)


def write_dataset(tmp_path):
    (tmp_path / "poses.csv").write_text(POSES_CSV)
    (tmp_path / "f1.jpg").write_bytes(b"")
    rng = np.random.default_rng(2)
    for name in ("f1", "f2"):
        np.save(tmp_path / f"{name}.npy",
                rng.uniform(0.5, 3.0, (8, 8)).astype(np.float32))


def test_geofusion_dataset_matches_jax(tmp_path):
    write_dataset(tmp_path)
    kw = dict(image_dir=str(tmp_path), depth_dir=str(tmp_path))
    jds = jrec.GeoFusionDataset(str(tmp_path / "poses.csv"), **kw)
    tds = trec.GeoFusionDataset(str(tmp_path / "poses.csv"), **kw)
    assert len(tds) == len(jds) == 2
    for i in range(2):
        jf, tf = jds[i], tds[i]
        for field in ("image_name", "image_path", "depth_path", "timestamp",
                      "accuracy_xy_m", "accuracy_z_m"):
            assert getattr(tf, field) == getattr(jf, field), field
        for field in ("position_ecef", "position_norm", "rotation_cam_to_ecef"):
            equal(getattr(tf, field), getattr(jf, field))
        equal(tds.load_depth(i), jds.load_depth(i))
    for key, value in jds.poses().items():
        equal(tds.poses()[key], value)


def test_candidates_and_euler_match_jax():
    jc, tc = jrec.candidate_transforms(), trec.candidate_transforms()
    assert [label for label, _ in tc] == [label for label, _ in jc]
    for (_, t), (_, j) in zip(tc, jc):
        equal(t, j)
    for angles in ((0, 0, 90), (10, 20, 30), (-5, 12.5, 181)):
        equal(trec.euler_adjust_matrix(*angles),
              jrec.euler_adjust_matrix(*angles))


def test_apply_view_transform_matches_jax_and_aligns():
    cands = trec.candidate_transforms()
    true_m = cands[7][1]
    world = np.random.default_rng(0).normal(size=(200, 3))
    r = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))[0]
    if np.linalg.det(r) < 0:
        r[:, 0] *= -1
    t = np.random.default_rng(11).normal(size=3)
    p_cam = (world - t) @ (r @ true_m)
    adjust = trec.euler_adjust_matrix(5, -10, 15)
    for m, a in ((true_m, None), (cands[3][1], None), (true_m, adjust)):
        equal(trec.apply_view_transform(p_cam, r, t, m, adjust=a),
              jrec.apply_view_transform(p_cam, r, t, m, adjust=a))
    np.testing.assert_allclose(trec.apply_view_transform(p_cam, r, t, true_m),
                               world, atol=1e-8)


def demo_views(module, colors=True):
    rng = np.random.default_rng(0)
    return [module.ViewCloud(
        points_cam=rng.normal(size=(100, 3)).astype(np.float32),
        colors=(rng.random((100, 3)) * 255).astype(np.uint8) if colors
        else None,
        rotation_body_to_world=np.eye(3), translation=np.zeros(3),
        name=f"v{i}</script>") for i in range(2)]


@pytest.mark.parametrize("colors", [True, False])
def test_viewer_html_and_file_match_jax(tmp_path, colors):
    tv, jv = demo_views(trec, colors), demo_views(jrec, colors)
    assert trec.render_viewer_html(tv) == jrec.render_viewer_html(jv)
    assert (trec.render_viewer_html(tv, "a <b> title")
            == jrec.render_viewer_html(jv, "a <b> title"))
    from deepearth_tpu.reconstruction.interactive import scene_to_json as jjson
    from deepearth_tpu_torch.reconstruction.interactive import scene_to_json
    assert scene_to_json(tv) == jjson(jv)
    trec.write_viewer(tv, str(tmp_path / "t.html"))
    jrec.write_viewer(jv, str(tmp_path / "j.html"))
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_build_scene_matches_jax(tmp_path):
    write_dataset(tmp_path)
    views = []
    for m in (jrec, trec):
        ds = m.GeoFusionDataset(
            str(tmp_path / "poses.csv"), depth_dir=str(tmp_path),
            intrinsics=m.CameraIntrinsics(fx=8, fy=8, cx=4, cy=4, width=8,
                                          height=8))
        views.append((m.build_scene(ds, stride=2, max_depth=2.5,
                                    max_points_per_view=10),
                       m.build_scene(ds, stride=1, use_norm_positions=False)))
    for jv, tv in zip(*views):
        assert len(tv) == len(jv) == 2
        for t, j in zip(tv, jv):
            assert t.name == j.name and t.colors is None and j.colors is None
            for field in ("points_cam", "rotation_body_to_world",
                          "translation"):
                equal(getattr(t, field), getattr(j, field))
    assert (trec.render_viewer_html(views[1][0])
            == jrec.render_viewer_html(views[0][0]))


def test_visualizer_route_serves_jax_html():
    tv, jv = demo_views(trec), demo_views(jrec)
    bodies = []
    for server, service in ((DashboardServer, DataService(viewer_views=tv)),
                            (JaxServer, JaxService(viewer_views=jv))):
        srv = server(service, port=0).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/visualizer",
                    timeout=30) as r:
                assert r.status == 200
                bodies.append((r.headers["Content-Type"], r.read()))
        finally:
            srv.stop()
    assert bodies[0] == bodies[1]
    assert bodies[0][1].decode() == trec.render_viewer_html(tv)


def test_plots_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    lat, lon = 28 + rng.random(50), -81 + rng.random(50)
    label = rng.integers(0, 5, 50)
    cloud, render, att = (rng.random((100, 3)), rng.random((16, 16, 3)),
                          rng.random((8, 8)))
    for name, args in (("plot_observation_map", (lat, lon, label)),
                       ("plot_point_cloud", (cloud,)),
                       ("save_render", (render,)),
                       ("plot_attention_map", (att,))):
        paths = [getattr(m, name)(*args, path=str(tmp_path / f"{tag}.png"))
                 for m, tag in ((trec, "t"), (jrec, "j"))]
        data = [open(p, "rb").read() for p in paths]
        assert len(data[0]) > 1000 and data[0] == data[1], name
