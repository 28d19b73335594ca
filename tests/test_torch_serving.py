"""The port's REST data service and its client (``deepearth_tpu_torch.
serving``) and the numpy modules it reads, on the CPU.

The routes are the JAX package's own tests of ``DashboardServer`` /
``DashboardClient`` (``tests/test_serving_data_engine.py``), run through the
port's, plus ``/api/predict`` answering the port's ``DeepEarth`` bit for bit,
its first requests arriving together, and ``/visualizer``, whose scene is not
ported yet. The port's copies of the numpy-only modules (projection and its
native UMAP, the mmap store, the observation data engine, the ecosystem,
spatiotemporal and retrieval metrics) give the JAX modules' outputs on the
same seeded inputs, exactly: the same numpy code.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deepearth_tpu_torch import api as tapi
from deepearth_tpu_torch.data import (
    DatasetConfig,
    ObservationDataset,
    UnifiedDataCache,
    convert_arrays_to_store,
)
from deepearth_tpu_torch.serving import (
    DashboardClient,
    DashboardServer,
    DataService,
)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_dataset(n=50, seed=0, cls=ObservationDataset):
    rng = np.random.default_rng(seed)
    return cls.from_arrays(
        gbif_id=np.arange(1000, 1000 + n),
        species=rng.choice(["Quercus", "Pinus", "Acer"], n),
        latitude=28.03 + rng.random(n) * 0.9,
        longitude=-81.93 + rng.random(n) * 1.0,
        altitude=rng.random(n) * 50,
        year=rng.integers(2010, 2026, n),
        month=rng.integers(1, 13, n),
    )


@pytest.fixture(scope="module")
def server():
    ds = make_dataset(30)
    cols = ds.columns()
    service = DataService(observations=cols)
    srv = DashboardServer(service, port=0).start()
    yield srv, cols
    srv.stop()


class TestServing:
    def test_health(self, server):
        srv, cols = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        h = c.health()
        assert h["status"] == "healthy"
        assert h["n_observations"] == 30

    def test_observations_bbox_filter(self, server):
        srv, cols = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        all_obs = c.observations()
        assert all_obs["count"] == 30
        tiny = c.observations(bbox=(28.03, -81.93, 28.10, -81.80))
        assert tiny["count"] < 30

    def test_single_observation_and_404(self, server):
        srv, cols = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        obs = c.observation(int(cols["gbif_id"][0]))
        assert obs["gbif_id"] == int(cols["gbif_id"][0])

        with pytest.raises(urllib.error.HTTPError):
            c.observation(42)

    def test_species_route(self, server):
        srv, _ = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        sp = c.species()
        assert sp["n_species"] == 3

    def test_training_batch_route(self, server):
        srv, cols = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        ids = [int(i) for i in cols["gbif_id"][:5]]
        out = c.training_batch(ids)
        assert out["found"] == [True] * 5
        assert len(out["locations"]) == 5
        bench = c.benchmark_training_batch(ids, runs=3)
        assert bench["p50_ms"] > 0

    def test_projection_route(self, server):
        srv, _ = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        emb = np.random.default_rng(0).standard_normal((20, 8))
        proj = c.projection(emb, n_components=2)
        assert proj.shape == (20, 2)

    def test_grid_statistics(self, server):
        srv, _ = server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        g = c._get("/api/grid_statistics?n_bins=5")
        assert np.asarray(g["grid"]).shape == (5, 5)
        assert np.asarray(g["grid"]).sum() == 30


class TestAnalysisRoutes:
    def test_attention_umap_ecosystem_routes(self, tmp_path):
        ds = make_dataset(40, seed=9)
        cols = ds.columns()
        ids = cols["gbif_id"][:40]
        rng = np.random.default_rng(10)
        # species-structured embeddings so ecosystems are meaningful
        proto = rng.standard_normal((3, 2, 4, 4, 16))
        vis = proto[cols["species"][:40]] + 0.05 * rng.standard_normal(
            (40, 2, 4, 4, 16)
        )
        vloader = convert_arrays_to_store(
            str(tmp_path / "va"), ids, vis.astype(np.float32)
        )
        service = DataService(observations=cols, vision_loader=vloader)
        srv = DashboardServer(service, port=0).start()
        try:
            c = DashboardClient(f"http://127.0.0.1:{srv.port}")
            att = c._get(f"/api/attention_map/{int(ids[0])}")
            assert att["shape"] == [4, 4]
            a = np.asarray(att["attention"])
            assert a.min() >= 0 and a.max() <= 1

            umap = c._get("/api/vision_umap?max_items=30&n_components=2")
            assert np.asarray(umap["projection"]).shape == (30, 2)

            eco = c._get("/api/ecosystems?n_clusters=3")
            assert len(eco["clusters"]) == 3
            assert all(cl["species_purity"] > 0.5 for cl in eco["clusters"])

            # interactive map route: self-contained HTML (no CDN)
            with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/api/ecosystem_map?n_clusters=3",
                timeout=60,
            ) as r:
                assert "text/html" in r.headers["Content-Type"]
                html = r.read().decode()
            assert "<canvas" in html and "https://" not in html
        finally:
            srv.stop()


class TestDashboardSurfaceRoutes:
    """Route-count parity with the reference dashboard
    (reference: dashboard/deepearth_dashboard.py:94-438)."""

    @pytest.fixture(scope="class")
    def full_server(self, tmp_path_factory):
        tmp_path = tmp_path_factory.mktemp("dash")
        ds = make_dataset(24, seed=4)
        cols = ds.columns()
        ids = cols["gbif_id"][:24]
        rng = np.random.default_rng(5)
        vis = rng.standard_normal((24, 2, 4, 4, 16)).astype(np.float32)
        vloader = convert_arrays_to_store(str(tmp_path / "vd"), ids, vis)
        img_dir = tmp_path / "imgs"
        img_dir.mkdir()
        (img_dir / f"{int(ids[0])}_1.png").write_bytes(
            bytes.fromhex(  # 1x1 png
                "89504e470d0a1a0a0000000d49484452000000010000000108060000001f"
                "15c4890000000d4944415478da63fccf0000030101004c2f0296c8000000"
                "0049454e44ae426082"
            )
        )
        static_dir = tmp_path / "static"
        static_dir.mkdir()
        (static_dir / "app.js").write_text("console.log('deepearth')")
        service = DataService(
            observations=cols, vision_loader=vloader,
            config={"dataset": "synthetic", "n": 24},
            image_dir=str(img_dir), static_dir=str(static_dir),
        )
        srv = DashboardServer(service, port=0).start()
        yield srv, service, cols, ids
        srv.stop()

    def test_index_html(self, full_server):
        srv, *_ = full_server
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/", timeout=30
        ) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/html")
        # '/' serves the interactive single-page app, packaged with the port
        assert "DeepEarth" in body and "/ui/app.js" in body
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/ui/app.js", timeout=30
        ) as r:
            assert r.read()

    def test_config_and_progress(self, full_server):
        srv, service, *_ = full_server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        assert c._get("/api/config")["dataset"] == "synthetic"
        assert c._get("/api/progress")["status"] == "idle"
        service.set_progress(status="training", step=42, loss=1.5)
        p = c._get("/api/progress")
        assert p["step"] == 42 and p["status"] == "training"

    def test_species_colors_and_observations(self, full_server):
        srv, _, cols, _ = full_server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        colors = c._get("/api/species_umap_colors")["colors"]
        assert len(colors) == len(np.unique(cols["species"]))
        for v in colors.values():
            assert len(v) == 3 and all(0 <= x <= 1 for x in v)
        sp = int(cols["species"][0])
        obs = c._get(f"/api/species/{sp}/observations")
        assert obs["count"] >= 1
        assert all(
            int(cols["species"][list(cols["gbif_id"]).index(o["gbif_id"])])
            == sp
            for o in obs["observations"]
        )

    def test_vision_available_and_feature_routes(self, full_server):
        srv, _, _, ids = full_server
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        avail = c._get("/api/vision_embeddings/available")
        assert avail["count"] == 24
        gid = int(ids[0])
        rgb = c._get(f"/api/features/{gid}/umap-rgb")
        assert rgb["shape"] == [4, 4, 3]
        arr = np.asarray(rgb["rgb"])
        assert arr.min() >= 0 and arr.max() <= 1
        stats = c._get(f"/api/features/{gid}/statistics")
        assert stats["channels"] == 16 and stats["patch_norm_max"] > 0
        pca = c._get(f"/api/features/{gid}/pca-raw")
        assert np.asarray(pca["components"]).shape == (4, 4, 3)
        att = c._get(f"/api/features/{gid}/attention")
        assert att["shape"] == [4, 4]

    def test_image_proxy_and_static(self, full_server):
        srv, _, _, ids = full_server
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(
            f"{base}/api/image_proxy/{int(ids[0])}/1", timeout=30
        ) as r:
            assert r.headers["Content-Type"] == "image/png"
            assert r.read()[:4] == b"\x89PNG"
        # missing image → 404 JSON
        try:
            urllib.request.urlopen(f"{base}/api/image_proxy/999999/1", timeout=30)
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
        with urllib.request.urlopen(f"{base}/static/app.js", timeout=30) as r:
            assert b"deepearth" in r.read()
        # path traversal rejected
        try:
            urllib.request.urlopen(
                f"{base}/static/../../etc/passwd", timeout=30
            )
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404


# -- /api/predict over the port's DeepEarth --------------------------------- #

REQUESTS = [((28.5, -81.4), "2024-06-15", {"temperature": [22.3], "species": 3}),
            ((27.9, -82.5, 40.0), "2031-01-02", {"temperature": [-4.0],
                                                 "species": 7}),
            ((-33.9, 151.2), None, {"temperature": [18.5], "species": 0}),
            ((64.1, -21.9), 0.75, {"temperature": [0.0], "species": 9})]


def quick_start(seed=0):
    earth = tapi.DeepEarth(hidden_dim=64, n_layers=1, seed=seed,
                           device="cpu")
    earth.register("temperature", shape=(1,), type="numerical")
    earth.register("species", type="categorical", num_classes=10)
    return earth


def test_predict_route_answers_the_port_s_deepearth():
    earth = quick_start()
    srv = DashboardServer(DataService(predictor=earth), port=0).start()
    try:
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")
        for location, t, data in REQUESTS:
            got = c.predict(location, t, data)
            want = earth.predict(location, t, data)
            assert got.dtype == np.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        # the JSON body is the embedding's float list
        body = DataService(predictor=earth).predict(
            {"location": list(REQUESTS[0][0]), "time": REQUESTS[0][1],
             "data": REQUESTS[0][2]})
        assert body == {"embedding": earth.predict(*REQUESTS[0]).tolist()}
        # a request without a predictor, or missing its location
        with pytest.raises(urllib.error.HTTPError) as e:
            c._post("/api/predict", {"time": None})
        assert e.value.code == 400
    finally:
        srv.stop()
    no_model = DashboardServer(DataService(), port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            DashboardClient(f"http://127.0.0.1:{no_model.port}").predict(
                (0.0, 0.0))
        assert e.value.code == 500
    finally:
        no_model.stop()


def test_first_requests_together_build_the_model_once():
    """``ThreadingHTTPServer`` serves each request on its own thread: eight
    first requests at once build one model, and each answer is the one a
    lone predict gives."""
    earth = quick_start(seed=1)
    builds = []
    build = earth._build
    barrier = threading.Barrier(8)

    def counted(names):
        builds.append(threading.get_ident())
        return build(names)

    earth._build = counted
    srv = DashboardServer(DataService(predictor=earth), port=0).start()
    answers = [None] * 8
    try:
        c = DashboardClient(f"http://127.0.0.1:{srv.port}")

        def ask(i):
            barrier.wait()
            answers[i] = c.predict(*REQUESTS[i % 4])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        srv.stop()
    assert len(builds) == 1
    for i, got in enumerate(answers):
        np.testing.assert_array_equal(got, earth.predict(*REQUESTS[i % 4]))


def test_visualizer_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item 19"):
        DataService(viewer_views=[{"points": np.zeros((4, 3))}])
    srv = DashboardServer(DataService(), port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/visualizer",
                                   timeout=30)
        assert e.value.code == 404
    finally:
        srv.stop()


# -- the numpy copies against the JAX package's modules --------------------- #


def test_projection_pca_and_umap_match_jax():
    from deepearth_tpu.utils.projection import EmbeddingProjector as JaxProj
    from deepearth_tpu_torch.utils import EmbeddingProjector

    x = np.random.default_rng(3).standard_normal((40, 12)).astype(np.float32)
    for method, k in (("pca", 3), ("umap", 2)):
        got = EmbeddingProjector(n_components=k, method=method)
        ref = JaxProj(n_components=k, method=method)
        np.testing.assert_array_equal(got.fit_transform(x),
                                      ref.fit_transform(x))
        # PCA projects new points with the fitted reducer; UMAP re-fits
        np.testing.assert_array_equal(got.transform(x[:20]),
                                      ref.transform(x[:20]))


def test_projection_disk_cache(tmp_path):
    from deepearth_tpu_torch.utils import EmbeddingProjector

    x = np.random.default_rng(4).standard_normal((10, 6)).astype(np.float32)
    a = EmbeddingProjector(2, "pca", cache_dir=str(tmp_path)).fit_transform(x)
    assert len(os.listdir(tmp_path)) == 1
    b = EmbeddingProjector(2, "pca", cache_dir=str(tmp_path)).fit_transform(x)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_mmap_store_round_trips_between_packages(tmp_path, dtype):
    """A store the port writes reads back through both packages' loaders
    (and the other way round): one on-disk format."""
    from deepearth_tpu.data import convert_arrays_to_store as jax_convert
    from deepearth_tpu.data import MMapEmbeddingLoader as JaxLoader
    from deepearth_tpu_torch.data import MMapEmbeddingLoader

    rng = np.random.default_rng(6)
    ids = rng.permutation(1000)[:12]
    emb = rng.standard_normal((12, 3, 5)).astype(np.float32)
    port = convert_arrays_to_store(str(tmp_path / "p"), ids, emb, dtype)
    jax_convert(str(tmp_path / "j"), ids, emb, dtype)
    ask = list(ids[::2]) + [5000]
    for loader in (port, JaxLoader(str(tmp_path / "p")),
                   MMapEmbeddingLoader(str(tmp_path / "j"))):
        got, found = loader.get_batch(ask)
        assert found.tolist() == [True] * 6 + [False]
        np.testing.assert_array_equal(
            got[:6], emb[::2].astype(dtype).astype(np.float32))
        np.testing.assert_array_equal(got[6], 0)
        assert loader.get(5000) is None
        np.testing.assert_array_equal(
            loader.get(int(ids[1])), emb[1].astype(dtype).astype(np.float32))


def test_unified_cache_batch_matches_jax(tmp_path):
    from deepearth_tpu import data as jdata

    batches = []
    for pkg, cls, conv in ((jdata, jdata.ObservationDataset,
                            jdata.convert_arrays_to_store),
                           (None, ObservationDataset,
                            convert_arrays_to_store)):
        ds = make_dataset(20, seed=2, cls=cls)
        rng = np.random.default_rng(1)
        ids = ds.df["gbif_id"].to_numpy()[:10]
        vis = rng.standard_normal((10, 4, 6, 6, 8)).astype(np.float32)
        lang = rng.standard_normal((10, 16)).astype(np.float32)
        tag = "j" if pkg else "p"
        config = (jdata.DatasetConfig if pkg else DatasetConfig)(cache_size=4)
        cache = (jdata.UnifiedDataCache if pkg else UnifiedDataCache)(
            ds, config, conv(str(tmp_path / f"v{tag}"), ids, vis),
            conv(str(tmp_path / f"l{tag}"), ids, lang))
        batches.append((cache.get_training_batch(ids[:4]),
                        ds.normalized_xyzt(bbox=(28.03, -81.93, 28.98,
                                                 -80.90)),
                        list(cache.batch_iterator(3, seed=5, steps=2,
                                                  process_shard=True))))
    ref, got = batches
    np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip([got[0]] + got[2], [ref[0]] + ref[2]):
        np.testing.assert_array_equal(a["xyzt"], b["xyzt"])
        assert set(a["modalities"]) == set(b["modalities"])
        for name in b["modalities"]:
            np.testing.assert_array_equal(a["modalities"][name],
                                          b["modalities"][name])


def test_ecosystems_match_jax():
    from deepearth_tpu.evaluation import ecosystems as jeco
    from deepearth_tpu_torch.evaluation import ecosystems as teco

    rng = np.random.default_rng(7)
    species = rng.integers(0, 4, 60)
    emb = rng.standard_normal((4, 16))[species] + 0.1 * rng.standard_normal(
        (60, 16))
    lat, lon = 28 + rng.random(60), -81 + rng.random(60)
    ref = jeco.analyze_ecosystems(emb, species, lat, lon, n_clusters=4)
    got = teco.analyze_ecosystems(emb, species, lat, lon, n_clusters=4)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert got["silhouette"] == ref["silhouette"]
    for a, b in zip(got["clusters"], ref["clusters"]):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(a.pop("centroid"), b.pop("centroid"))
        assert a == b
    sim = teco.species_similarity(emb, species, top_k=3)
    sim_ref = jeco.species_similarity(emb, species, top_k=3)
    assert sim["pairs"] == sim_ref["pairs"]
    np.testing.assert_array_equal(sim["similarity"], sim_ref["similarity"])
    assert (teco.ecosystem_map_html(lat, lon, ref["labels"])
            == jeco.ecosystem_map_html(lat, lon, ref["labels"]))


def test_spatiotemporal_metrics_match_jax():
    from deepearth_tpu.evaluation import spatiotemporal as jst
    from deepearth_tpu_torch.evaluation import spatiotemporal as tst

    rng = np.random.default_rng(8)
    coords = rng.random((80, 2))
    values = np.sin(coords[:, 0] * 6) + 0.1 * rng.standard_normal(80)
    times = rng.random(80)
    pred, true = rng.standard_normal((80, 3)), rng.standard_normal((80, 3))
    assert tst.morans_i(values, coords) == jst.morans_i(values, coords)
    assert (tst.temporal_consistency(values, times)
            == jst.temporal_consistency(values, times))
    for a, b in ((tst.binned_rmse(pred, true, times, 5),
                  jst.binned_rmse(pred, true, times, 5)),
                 (tst.SpatiotemporalMetrics.spatial_binned_rmse(
                     pred, true, coords, axis=1),
                  jst.SpatiotemporalMetrics.spatial_binned_rmse(
                      pred, true, coords, axis=1))):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    lat, lon = 28 + rng.random(10), -81 + rng.random(10)
    np.testing.assert_array_equal(tst.haversine_like(lat, lon, 28.5, -80.5),
                                  jst.haversine_like(lat, lon, 28.5, -80.5))


def test_retrieval_metrics_match_jax():
    from deepearth_tpu.evaluation import retrieval as jret
    from deepearth_tpu_torch.evaluation import retrieval as tret

    rng = np.random.default_rng(9)
    a = rng.standard_normal((30, 8))
    b = a + 0.5 * rng.standard_normal((30, 8))
    labels = rng.integers(0, 5, 30)
    assert (tret.cross_modal_retrieval(a, b)
            == jret.cross_modal_retrieval(a, b))
    assert (tret.retrieval_metrics(a, b, (1, 3), labels)
            == jret.retrieval_metrics(a, b, (1, 3), labels))


def test_service_modules_import_and_predict_without_jax():
    """The embedding service, its server and client, the registry and the
    copied modules import with JAX and the JAX package blocked, and a
    request goes through the server on the CPU."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'deepearth_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import deepearth_tpu_torch.api as api\n"
        "import deepearth_tpu_torch.registry, deepearth_tpu_torch.data\n"
        "import deepearth_tpu_torch.evaluation, deepearth_tpu_torch.utils\n"
        "import deepearth_tpu_torch.utils.umap_native\n"
        "from deepearth_tpu_torch.serving import (DashboardClient,\n"
        "    DashboardServer, DataService)\n"
        "earth = api.DeepEarth(hidden_dim=64, n_layers=1, device='cpu')\n"
        "earth.register('t', shape=(2,))\n"
        "srv = DashboardServer(DataService(predictor=earth)).start()\n"
        "got = DashboardClient(f'http://127.0.0.1:{srv.port}').predict(\n"
        "    (1.0, 2.0), None, {'t': [1.0, 2.0]})\n"
        "srv.stop()\n"
        "assert np.array_equal(got, earth.predict((1.0, 2.0), None,\n"
        "                                         {'t': [1.0, 2.0]}))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepearth_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
