"""Gaussian splatting on the port (``reconstruction/gaussian_splat.py`` over
``ops/splat.py``) against the JAX package's
``deepearth_tpu/reconstruction/gaussian_splat.py``, on the CPU, where the
binning and the compositing run their plain versions (K8's and K9's
kernels are held against those on the card, in
``tests/test_torch_kernels_cuda.py``).

Scenes come from numpy with a seed (some Gaussians behind the camera; see
:func:`in_front` for why JAX renders the rest) and go to the port through
``convert.gaussian_scene_from_jax``; 32 x 32 images,
G <= 300, per-tile budgets K of 8 and 120 (tiles over budget, and empty
tiles for the clustered scene). Limits: the projection's fp32 arrays
within 1e-6 of each array's largest entry (matrix products summed in
another order); images within 1e-5 of their largest entry (the same
compositing, cumprod and the colour sums in another order); K8's selection
equal to ``lax.top_k``'s in every filled slot; gradients of the MSE for all
five scene fields within 1e-4 of each field's largest entry; three Adam
steps against optax within 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepearth_tpu.reconstruction import gaussian_splat as jgs
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.convert import camera_from_jax, gaussian_scene_from_jax
from deepearth_tpu_torch.ops import splat
from deepearth_tpu_torch.reconstruction import gaussian_splat as tgs
from deepearth_tpu_torch.training.optimizers import Adam, AdamState

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402  (the repository's root, above)

torch.set_num_threads(2)

SIZE = 32


def jax_camera(w=SIZE, h=SIZE):
    return jgs.Camera(rotation=jnp.eye(3),
                      translation=jnp.asarray([0.0, 0.0, 2.0]),
                      fx=32.0, fy=32.0, cx=w / 2, cy=h / 2, width=w, height=h)


def numpy_scene(seed, g=300, behind=12, extent=1.0, spread=0.3):
    """A random scene: ``behind`` Gaussians behind the camera (z < -2)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (g, 3))
    means[:behind, 2] = rng.uniform(-3.5, -2.2, behind)
    quats = rng.normal(size=(g, 4))
    return jgs.GaussianScene(
        means=jnp.asarray(means, jnp.float32),
        log_scales=jnp.asarray(np.log(0.08) + spread * rng.normal(size=(g, 3)),
                               jnp.float32),
        quats=jnp.asarray(quats, jnp.float32),
        colors=jnp.asarray(rng.normal(size=(g, 3)), jnp.float32),
        opacity_logits=jnp.asarray(rng.normal(0.5, 1.5, g), jnp.float32))


def clustered_scene(seed):
    """Gaussians in one corner: most tiles get none."""
    s = numpy_scene(seed, g=64, behind=4, extent=0.15)
    return s._replace(means=s.means + jnp.asarray([-0.6, -0.6, 0.0]))


def both(scene):
    return scene, gaussian_scene_from_jax(scene)


def in_front(scene):
    """The rows of a JAX scene in front of the camera (camera z = world z
    + 2 > 0) and their mask. JAX's own renders of a Gaussian behind the
    camera are not usable as a reference: its cov2d overflows (~1e24) and
    its inverse is NaN, which JAX's dense render sends into that
    Gaussian's gradients and its tiled render, through an unfilled slot
    that gathers it, into the image. The port zeroes such a Gaussian before
    compositing, so it shows nowhere and gets a zero gradient; without it
    JAX computes the same image and the same gradients for the others."""
    keep = np.asarray(scene.means[:, 2]) > -2.0
    return jgs.GaussianScene(*(f[keep] for f in scene)), keep


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_projection_matches_jax():
    js, ts = both(in_front(numpy_scene(0))[0])
    jcam = jax_camera()
    tcam = camera_from_jax(jcam)
    assert rel_err(tgs.quat_to_rotmat(ts.quats),
                   jgs.quat_to_rotmat(js.quats)) <= 1e-6
    assert rel_err(tgs.covariance_3d(ts), jgs.covariance_3d(js)) <= 1e-6
    for got, ref in zip(tgs.project_gaussians(ts, tcam),
                        jgs.project_gaussians(js, jcam)):
        assert rel_err(got, ref) <= 1e-6
    cov = jgs.project_gaussians(js, jcam)[1]
    for got, ref in zip(tgs._inverse_cov2d(torch.tensor(np.asarray(cov))),
                        jgs._inverse_cov2d(cov)):
        assert rel_err(got, ref) <= 1e-6


RENDERS = {  # name: (renderer, per-tile budget K, background, scene)
    "dense": ("dense", None, False, numpy_scene),
    "dense_bg": ("dense", None, True, numpy_scene),
    "tiled_k120": ("tiled", 120, False, numpy_scene),
    "tiled_k120_bg": ("tiled", 120, True, numpy_scene),
    "tiled_k8_over_budget": ("tiled", 8, True, numpy_scene),
    "tiled_empty_tiles": ("tiled", 8, True, clustered_scene),
}


def renderers(name):
    kind, k, bg, make = RENDERS[name]
    js, ts = both(make(1))
    jbg = jnp.asarray([0.2, 0.3, 0.4]) if bg else None
    tbg = torch.tensor([0.2, 0.3, 0.4]) if bg else None
    jcam = jax_camera()
    tcam = camera_from_jax(jcam)
    if kind == "dense":
        return (js, lambda s: jgs.render(s, jcam, jbg),
                ts, lambda s: tgs.render(s, tcam, tbg))
    return (js, lambda s: jgs.render_tiled(s, jcam, jbg, max_per_tile=k),
            ts, lambda s: tgs.render_tiled(s, tcam, tbg, max_per_tile=k))


@pytest.mark.parametrize("name", RENDERS)
def test_render_matches_jax(name):
    js, jrender, ts, trender = renderers(name)
    front, keep = in_front(js)
    assert (~keep).sum() > 0
    ref = np.asarray(jax.jit(jrender)(front))
    got = trender(ts).detach().numpy()
    assert got.shape == (SIZE, SIZE, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if RENDERS[name][0] == "dense":  # JAX's image of the whole scene too
        whole = np.asarray(jax.jit(jrender)(js))
        assert np.abs(got - whole).max() <= 1e-5 * np.abs(whole).max()


def jax_tile_selection(scene, cam, k, ts=16):
    """JAX's render_tiled selection, written out from its source: xy,
    radius and valid of the sorted Gaussians, and lax.top_k per tile."""
    xy, cov2d, depth = jgs.project_gaussians(scene, cam)
    order = jnp.argsort(depth)
    xy, depth, cov2d = xy[order], depth[order], cov2d[order]
    a, b, c = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]
    lam_max = 0.5 * (a + c) + jnp.sqrt(
        jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    radius = 3.5 * jnp.sqrt(jnp.maximum(lam_max, 0.0))
    valid = depth > 1e-4
    kidx, ok = jax_top_k(xy, radius, valid, cam.width // ts,
                         cam.height // ts, ts, k)
    return xy, radius, valid, kidx, ok


def jax_top_k(xy, radius, valid, tiles_x, tiles_y, ts, k):
    """render_tiled's intersect test and lax.top_k over every tile at once
    (its lax.map over chunks of tiles selects each tile alone): each tile's
    first k hits (kidx, ok)."""
    g = xy.shape[0]
    tile_iy, tile_ix = jnp.divmod(jnp.arange(tiles_x * tiles_y), tiles_x)
    centers = jnp.stack([tile_ix * ts + ts / 2.0, tile_iy * ts + ts / 2.0],
                        axis=-1)
    dxy = jnp.abs(xy[None] - centers[:, None, :])
    hit = valid[None] & jnp.all(dxy <= ts / 2.0 + radius[None, :, None],
                                axis=-1)
    key = jnp.where(hit, -jnp.arange(g, dtype=jnp.int32)[None], -(g + 1))
    kv, kidx = jax.lax.top_k(key, k)
    return np.asarray(kidx), np.asarray(kv > -(g + 1))


def assert_top_k(idx, count, kidx, ok):
    """K8's lists (idx, count) are JAX's selection: the same hits in the
    filled slots, the rest 0."""
    k = idx.shape[1]
    np.testing.assert_array_equal(count.numpy(), ok.sum(-1))
    filled = np.arange(k)[None] < count.numpy()[:, None]
    np.testing.assert_array_equal(filled, ok)
    np.testing.assert_array_equal(idx.numpy()[ok], kidx[ok])
    assert (idx.numpy()[~ok] == 0).all()


@pytest.mark.parametrize("k", [8, 120, 300])
@pytest.mark.parametrize("make", [numpy_scene, clustered_scene],
                         ids=["spread", "clustered"])
def test_bin_tiles_equals_top_k(make, k):
    scene = make(2)
    k = min(k, scene.means.shape[0])
    xy, radius, valid, kidx, ok = jax_tile_selection(scene, jax_camera(), k)
    idx, count = splat.bin_tiles(
        torch.tensor(np.asarray(xy)), torch.tensor(np.asarray(radius)),
        torch.tensor(np.asarray(valid)), SIZE // 16, SIZE // 16, 16, k)
    assert_top_k(idx, count, kidx, ok)


@pytest.mark.parametrize("chunk", [None, 7, 100])
@pytest.mark.parametrize("k", [8, 120, 300])
@pytest.mark.parametrize("make", [numpy_scene, clustered_scene],
                         ids=["spread", "clustered"])
def test_bin_tiles_chunked_equals_top_k(make, k, chunk):
    """K8's algorithm (rectangles, counts per chunk, their prefix, the
    ordered write) in plain PyTorch gives JAX's selection, with chunks of
    kernels.splat_bin_chunk(G) (None: 64 here), 7 and 100, boundaries
    inside the tiles' first k."""
    scene = make(2)
    k = min(k, scene.means.shape[0])
    xy, radius, valid, kidx, ok = jax_tile_selection(scene, jax_camera(), k)
    idx, count = splat.bin_tiles_chunked_plain(
        torch.tensor(np.asarray(xy)), torch.tensor(np.asarray(radius)),
        torch.tensor(np.asarray(valid)), SIZE // 16, SIZE // 16, 16, k,
        chunk)
    assert_top_k(idx, count, kidx, ok)


BIN_EDGES = {**smoke.splat_bin_edges("cpu"), **smoke.splat_bin_grids("cpu")}


@pytest.mark.parametrize("name", BIN_EDGES)
def test_bin_tiles_edges_equal_top_k(name):
    """Both plain versions of K8 against JAX's test and top_k at
    chip_smoke.splat_bin_edges' cases (box edges on tile centres, infinite,
    negative and NaN reaches, means of +-1e30 and far off screen, NaN
    means marked valid, nothing valid, k = G, grids that are not square,
    chunk boundaries inside the first k, G not a multiple of the chunk,
    chunks whose first slot is past k, tiles of 10) and splat_bin_grids'
    large grids."""
    xy, radius, valid, tiles_x, tiles_y, ts, k, chunk = BIN_EDGES[name]
    kidx, ok = jax_top_k(jnp.asarray(xy.numpy()), jnp.asarray(radius.numpy()),
                         jnp.asarray(valid.numpy()), tiles_x, tiles_y, ts, k)
    binning = (xy, radius, valid, tiles_x, tiles_y, ts, k)
    assert_top_k(*splat.bin_tiles_plain(*binning), kidx, ok)
    assert_top_k(*splat.bin_tiles_chunked_plain(*binning, chunk), kidx, ok)


@pytest.mark.parametrize("name", RENDERS)
def test_gradients_match_jax(name):
    js, jrender, ts, trender = renderers(name)
    rng = np.random.default_rng(3)
    target = rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    front, keep = in_front(js)
    ref = jax.jit(jax.grad(
        lambda s: jnp.mean((jrender(s) - target) ** 2)))(front)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    loss = torch.mean((trender(tgs.GaussianScene(*leaves))
                       - torch.tensor(target)) ** 2)
    got = torch.autograd.grad(loss, leaves)
    for field, g, r in zip(tgs.GaussianScene._fields, got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy()[keep] - r).max() <= 1e-4 * np.abs(r).max(), \
            field
        # the Gaussians behind the camera receive no gradient
        assert (g.numpy()[~keep] == 0).all(), field


@pytest.mark.parametrize("renderer", ["dense", "tiled"])
def test_three_train_steps_match_optax(renderer):
    js, ts = both(numpy_scene(4, g=200, behind=0))
    jcam = jax_camera()
    target = np.random.default_rng(5).uniform(
        0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    jinit, jstep = jgs.make_train_step(jcam, lr=1e-2, renderer=renderer)
    tinit, tstep = tgs.make_train_step(camera_from_jax(jcam), lr=1e-2,
                                       renderer=renderer)
    jopt, topt = jinit(js), tinit(ts)
    for _ in range(3):
        js, jopt, jloss = jstep(js, jopt, jnp.asarray(target))
        ts, topt, tloss = tstep(ts, topt, torch.tensor(target))
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    for field, got, ref in zip(tgs.GaussianScene._fields, ts, js):
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5, field
    # the moments as optax holds them
    adam = jopt[0]
    for got, ref in ((topt.mu, adam.mu), (topt.nu, adam.nu)):
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    assert topt.count == int(adam.count) == 3


def test_adam_matches_optax_on_fixed_gradients():
    rng = np.random.default_rng(6)
    params = tgs.GaussianScene(*(torch.tensor(rng.normal(size=s), dtype=torch.float32)
                                 for s in ((5, 3), (5, 3), (5, 4), (5, 3), (5,))))
    tx, jtx = Adam(3e-2), optax.adam(3e-2)
    state, jstate = tx.init(params), jtx.init(
        jgs.GaussianScene(*(jnp.asarray(p.numpy()) for p in params)))
    for _ in range(4):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        upd, state = tx.update(tgs.GaussianScene(*map(torch.tensor, grads)),
                               state)
        jupd, jstate = jtx.update(jgs.GaussianScene(*map(jnp.asarray, grads)),
                                  jstate)
        for u, ju in zip(upd, jupd):
            np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5,
                                       atol=1e-9)


def densify_case():
    """The JAX test's scene: rows 0-1 pruned, row 2 cloned, row 3 split."""
    js = numpy_scene(7, g=8, behind=0, extent=0.5)
    js = js._replace(
        opacity_logits=jnp.asarray([-9.0, -9.0, 2.0, 2.0, 0.0, 0.0, 0.0, 0.0]),
        log_scales=jnp.full((8, 3), np.log(0.1), jnp.float32).at[3].set(
            jnp.log(0.2)))
    grads = np.asarray([1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]) * 1e-2
    return js, grads


def test_densify_and_prune_matches_jax():
    js, grads = densify_case()
    kw = dict(grad_threshold=1e-3, split_scale=0.15, min_opacity=0.01)
    jnew, jsrc = jgs.densify_and_prune(js, jnp.asarray(grads),
                                       jax.random.PRNGKey(1), **kw)
    ts = gaussian_scene_from_jax(js)
    tnew, tsrc = tgs.densify_and_prune(
        ts, torch.tensor(grads), torch.Generator().manual_seed(1), **kw)
    np.testing.assert_array_equal(tsrc, np.asarray(jsrc))
    child = np.zeros(len(tsrc), bool)
    child[-2:] = True  # the two children of the split row
    for field, got, ref in zip(tgs.GaussianScene._fields, tnew, jnew):
        if field in ("means", "log_scales"):
            np.testing.assert_array_equal(got.numpy()[~child],
                                          np.asarray(ref)[~child])
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the children: JAX's formula on the port's own draw
    eps = torch.randn(tnew.means.shape, generator=torch.Generator().manual_seed(1))
    parent = jgs.GaussianScene(*(jnp.asarray(np.asarray(f)[tsrc]) for f in js))
    offs = jnp.einsum("gij,gj->gi", jgs.quat_to_rotmat(parent.quats),
                      jnp.asarray(eps.numpy()) * jnp.exp(parent.log_scales))
    np.testing.assert_allclose(tnew.means.numpy()[child],
                               np.asarray(parent.means + offs)[child],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tnew.log_scales.numpy()[child],
        np.asarray(parent.log_scales - jnp.log(1.6))[child])


def test_prune_and_reset_opacity_bit_for_bit():
    js, _ = densify_case()
    ts = gaussian_scene_from_jax(js)
    for jout, tout in ((jgs.prune_scene(js, 0.3), tgs.prune_scene(ts, 0.3)),
                       (jgs.reset_opacity(js, 0.01), tgs.reset_opacity(ts, 0.01))):
        for got, ref in zip(tout, jout):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fit_scene_adaptive_remaps_moments(monkeypatch):
    """Every resize remaps both Adam moments row by row (children inherit
    their parent's), and the fit's loss falls."""
    js = numpy_scene(8, g=12, behind=0, extent=0.15)._replace(
        opacity_logits=jnp.full((12,), 2.5))
    jcam = jax_camera(24, 24)
    target = torch.tensor(np.asarray(jgs.render(js, jcam)))
    tcam = camera_from_jax(jcam)
    remaps = []
    original = AdamState.remap

    def remap(self, src):
        out = original(self, src)
        remaps.append((self, np.asarray(src), out))
        return out

    monkeypatch.setattr(AdamState, "remap", remap)
    first = []
    step_fn = tgs._step_fn

    def recording_step(*args, **kw):
        step = step_fn(*args, **kw)

        def wrapped(*a):
            out = step(*a)
            first.append(float(out[2]))
            return out
        return wrapped

    monkeypatch.setattr(tgs, "_step_fn", recording_step)
    scene, loss = tgs.fit_scene_adaptive(
        target, tcam, n_init=8, steps=60, densify_every=20, lr=2e-2, seed=0,
        extent=0.5, grad_threshold=1e-5, split_scale=0.08)
    assert len(remaps) == 2
    assert any(len(src) != len(before.mu.means) for before, src, _ in remaps)
    for before, src, after in remaps:
        assert after.count == before.count
        for moments_b, moments_a in ((before.mu, after.mu),
                                     (before.nu, after.nu)):
            for b, a in zip(moments_b, moments_a):
                assert a.shape[0] == len(src)
                for i, s in enumerate(src):
                    assert torch.equal(a[i], b[s])
    assert scene.means.shape[0] == len(remaps[-1][1])
    assert loss < 0.5 * first[0]


def test_render_tiled_refuses_ragged_tiles_and_counts_nothing_on_cpu():
    _, ts = both(numpy_scene(9, g=20))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):
        tgs.render_tiled(ts, camera_from_jax(jax_camera()), tile_size=24)
    tgs.render_tiled(ts, camera_from_jax(jax_camera()))
    tgs.render(ts, camera_from_jax(jax_camera()))
    assert set(kernels.launch_counts.values()) == {0}


def test_composite_bwd_plain_is_autograd_of_the_forward():
    rng = np.random.default_rng(10)
    lists, k = 4, 6
    xy = torch.tensor(rng.uniform(0, 16, (lists, k, 2)), dtype=torch.float32)
    abc = torch.tensor(rng.uniform(0.05, 0.3, (lists, k, 3)) * [1, 0.1, 1],
                       dtype=torch.float32)
    opac = torch.tensor(rng.uniform(0, 1, (lists, k)), dtype=torch.float32)
    opac[0, 2] = 0.0  # an unfilled slot
    color = torch.tensor(rng.uniform(0, 1, (lists, k, 3)), dtype=torch.float32)
    bg = torch.tensor([0.1, 0.2, 0.3])
    dout = torch.tensor(rng.normal(size=(16, 16, 3)), dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (xy, abc, opac, color, bg)]
    out = splat.composite(*leaves, 16, 16, 8, 8)
    ref = torch.autograd.grad(out, leaves, dout)
    got = splat.composite_bwd_plain(xy, abc, opac, color, bg, dout, 16, 16, 8, 8)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
