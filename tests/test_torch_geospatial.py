"""The port's geospatial layer (``deepearth_tpu_torch.geospatial``) against
the JAX package's: each case of ``tests/test_geospatial.py`` runs through
both, the port's results must equal JAX's within 1e-12 (float64, the same
numpy operations), and the port must pass the case's own golden checks.
"""

import numpy as np
import pytest

import deepearth_tpu.geospatial as jgeo
import deepearth_tpu_torch.geospatial as tgeo

TOL = 1e-12

LANDMARKS = np.array(
    [
        [28.5, -81.4, 30.0],
        [37.7749, -122.4194, 10.0],
        [51.5007, -0.1246, 35.0],
        [-33.8688, 151.2093, 58.0],
        [0.0, 0.0, 0.0],
        [89.9999, 45.0, 100.0],
        [-89.9999, -135.0, 0.0],
        [0.0, 179.99999, -50.0],
        [35.6762, 139.6503, 40.0],
        [-13.1631, -72.5450, 2430.0],
    ],
    dtype=np.float64,
)


def same(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL)


def test_exports_match():
    assert sorted(tgeo.__all__) == sorted(jgeo.__all__)
    for name in ("WGS84_A", "WGS84_E2", "WGS84_F"):
        assert getattr(tgeo, name) == getattr(jgeo, name)


def test_geodetic_ecef_roundtrip():
    xyz = tgeo.geodetic_to_ecef(LANDMARKS)
    same(xyz, jgeo.geodetic_to_ecef(LANDMARKS))
    geo2 = tgeo.ecef_to_geodetic(xyz)
    same(geo2, jgeo.ecef_to_geodetic(xyz))
    err_m = np.linalg.norm(tgeo.geodetic_to_ecef(geo2) - xyz, axis=-1)
    assert np.all(err_m < 1e-6)
    lat_err = tgeo.wrap_lat_error(LANDMARKS[:, 0], geo2[:, 0])
    lon_err = tgeo.wrap_lon_error(LANDMARKS[:, 1], geo2[:, 1], LANDMARKS[:, 0])
    same(lat_err, jgeo.wrap_lat_error(LANDMARKS[:, 0], geo2[:, 0]))
    same(lon_err, jgeo.wrap_lon_error(LANDMARKS[:, 1], geo2[:, 1],
                                      LANDMARKS[:, 0]))
    assert np.all(lat_err < 1e-9) and np.all(lon_err < 1e-9)
    assert np.all(np.abs(LANDMARKS[:, 2] - geo2[:, 2]) < 1e-6)


def test_known_ecef_origin():
    xyz = tgeo.geodetic_to_ecef(np.array([0.0, 0.0, 0.0]))
    same(xyz, jgeo.geodetic_to_ecef(np.array([0.0, 0.0, 0.0])))
    np.testing.assert_allclose(xyz, [6_378_137.0, 0.0, 0.0], atol=1e-9)


@pytest.mark.parametrize("norm_dtype", [np.float64, np.float16])
def test_norm_roundtrip(norm_dtype):
    xyz = tgeo.geodetic_to_ecef(LANDMARKS)
    conv = tgeo.GeospatialConverter(norm_dtype=norm_dtype)
    ref = jgeo.GeospatialConverter(norm_dtype=norm_dtype)
    norm = conv.xyz_to_norm(xyz)
    same(norm, ref.xyz_to_norm(xyz))
    # a continental span cannot be held in float16: the dtype is upgraded
    assert norm.dtype in (np.float32, np.float64)
    back = conv.norm_to_xyz(norm)
    same(back, ref.norm_to_xyz(norm))
    if norm_dtype == np.float64:
        assert np.abs(back - xyz).max() < 1e-6


def test_degenerate_span_maps_to_half():
    pts = np.tile(tgeo.geodetic_to_ecef(np.array([[28.5, -81.4, 30.0]])),
                  (4, 1))
    norm = tgeo.GeospatialConverter().xyz_to_norm(pts)
    same(norm, jgeo.GeospatialConverter().xyz_to_norm(pts))
    np.testing.assert_allclose(norm, 0.5)


def test_orientation():
    ypr = np.array([[10.0, 20.0, 30.0], [-45.0, 5.0, 0.0],
                    [120.0, -30.0, 60.0]])
    R = tgeo.ypr_to_rotation(ypr)
    same(R, jgeo.ypr_to_rotation(ypr))
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    same(tgeo.rotation_to_ypr(R), jgeo.rotation_to_ypr(R))
    np.testing.assert_allclose(tgeo.rotation_to_ypr(R), ypr, atol=1e-9)
    same(tgeo.ned_to_ecef_rotation(LANDMARKS),
         jgeo.ned_to_ecef_rotation(LANDMARKS))
    same(tgeo.GeoOrientation(0.0, 0.0, 0.0).to_rotation_matrix(), np.eye(3))


def test_converter_returns_camera_rotation():
    ori = np.array([[0.0, 0.0, 0.0], [90.0, 0.0, 0.0], [10.0, -5.0, 3.0]])
    xyz, R = tgeo.GeospatialConverter().geodetic_to_xyz(LANDMARKS[:3],
                                                        orientation=ori)
    jxyz, jR = jgeo.GeospatialConverter().geodetic_to_xyz(LANDMARKS[:3],
                                                          orientation=ori)
    same(xyz, jxyz)
    same(R, jR)
    assert R.shape == (3, 3, 3)


def test_utils():
    for v in (91.0, -91.0, 45.0, 181.0):
        assert tgeo.wrap_lat(v) == jgeo.wrap_lat(v)
    assert tgeo.wrap_lat(181.0) == pytest.approx(-1.0)
    same(tgeo.wrap_lat_array(np.array([91.0, -181.0, 12.0])),
         jgeo.wrap_lat_array(np.array([91.0, -181.0, 12.0])))
    out = tgeo.safe_div(np.array([1.0, 2.0]), np.array([0.0, 2.0]))
    same(out, jgeo.safe_div(np.array([1.0, 2.0]), np.array([0.0, 2.0])))
    np.testing.assert_allclose(out, [0.5, 1.0])
    err = tgeo.wrap_lon_error(np.array([179.9]), np.array([-179.9]),
                              np.array([0.0]))
    assert err[0] == pytest.approx(0.2, abs=1e-9)
    for n in (0, 999, 1234, 5_600_000):
        assert tgeo.human_unit(n, "m") == jgeo.human_unit(n, "m")


def _coords(mod, conv, geo):
    xyz, _ = conv.geodetic_to_xyz(geo)
    norm = conv.xyz_to_norm(xyz)
    return [
        mod.CoordinateSet(
            lat=geo[i, 0], lon=geo[i, 1], alt=geo[i, 2],
            x=xyz[i, 0], y=xyz[i, 1], z=xyz[i, 2],
            rel_x=norm[i, 0], rel_y=norm[i, 1], rel_z=norm[i, 2],
            bbox=conv.bbox, timestamp=1700000000.0 + i,
            orientation=mod.GeoOrientation(1.0 * i, 2.0 * i, 3.0 * i),
        )
        for i in range(len(geo))
    ]


def test_csv_roundtrip_reads_across_packages(tmp_path):
    """The port writes JAX's CSV bytes, and each reads the other's file."""
    conv, jconv = tgeo.GeospatialConverter(), jgeo.GeospatialConverter()
    coords = _coords(tgeo, conv, LANDMARKS[:4])
    conv.export_coordinates(str(tmp_path / "port.csv"), coords)
    jconv.export_coordinates(str(tmp_path / "jax.csv"),
                             _coords(jgeo, jconv, LANDMARKS[:4]))
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    loaded = conv.import_coordinates(str(tmp_path / "jax.csv"))
    assert len(loaded) == 4
    for a, b in zip(coords, loaded):
        assert b.lat == pytest.approx(a.lat, abs=1e-12)
        assert b.x == pytest.approx(a.x, abs=1e-6)
        assert b.rel_z == pytest.approx(a.rel_z, abs=1e-12)
        assert b.orientation.yaw == pytest.approx(a.orientation.yaw)


def test_geofusion_loader(tmp_path):
    (tmp_path / "geofusion.csv").write_text(
        "time,image,latitude,longitude,altitude,yaw,pitch,roll,xyAccuracy,"
        "zAccuracy\n"
        "1700000000.0,img_001,28.5,-81.4,30.0,10.0,2.0,-1.0,0.01,0.02\n"
        "1700000001.0,img_002,28.6,-81.5,31.0,11.0,2.5,-0.5,0.01,0.02\n")
    out = {}
    for mod in (tgeo, jgeo):
        conv = mod.GeospatialConverter()
        loader = mod.GeoFusionDataLoader(conv, data_dir=str(tmp_path))
        loader.load_csv("geofusion.csv")
        pos, ori = loader.convert_all()
        xyz, R = conv.geodetic_to_xyz(pos, orientation=ori)
        out[mod] = (loader.entries[0].image_name, pos, ori, xyz, R)
    assert out[tgeo][0] == out[jgeo][0] == "img_001.jpg"
    for port, ref in zip(out[tgeo][1:], out[jgeo][1:]):
        same(port, ref)
    assert out[tgeo][3].shape == (2, 3) and out[tgeo][4].shape == (2, 3, 3)


def test_bounding_box():
    pts_a = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    pts_b = np.array([[-1.0, 5.0, 1.0]])
    u = tgeo.BoundingBox.from_points(pts_a).union(
        tgeo.BoundingBox.from_points(pts_b))
    ref = jgeo.BoundingBox.from_points(pts_a).union(
        jgeo.BoundingBox.from_points(pts_b))
    same(u.min_point, ref.min_point)
    same(u.max_point, ref.max_point)
    np.testing.assert_allclose(u.min_point, [-1.0, 0.0, 0.0])
    np.testing.assert_allclose(u.max_point, [1.0, 5.0, 3.0])
