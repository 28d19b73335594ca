"""K9's segment algebra (``ops/splat.py`` ``composite_segments_plain`` and
``composite_segments_bwd_plain``) against the JAX package's ``render`` /
``render_tiled`` and ``jax.grad``, on the CPU.

The port's renders run with ``splat.composite`` replaced by the segment
algebra: each list cut into runs, each run composited with the
transmittance as mantissa and exponent, the runs combined; the backward
from the kept per-run state (the transmittance after each run, the colour
behind it), each run walked back to front. Scenes come from numpy with a
seed. Cases: runs that do not divide the list (the last one shorter), the
kernels' own split (``kernels.splat_plan``), a list shorter than one run
(K = 8 against runs of at least 128), K = 1, lists whose transmittance
underflows fp32 (every alpha at 0.995: ~17 entries take T below 2^-126),
with and without a background. Limits, fp32: images within 1e-5 of their
largest entry, gradients of the MSE for all five scene fields within 1e-4
of each field's largest entry (the same limits as JAX against the port's
plain compositing in ``test_torch_splat.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_splat import SIZE, both, in_front, jax_camera, numpy_scene

from deepearth_tpu.reconstruction import gaussian_splat as jgs
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.convert import camera_from_jax
from deepearth_tpu_torch.ops import splat
from deepearth_tpu_torch.reconstruction import gaussian_splat as tgs

torch.set_num_threads(2)


def saturated_scene(seed):
    """40 wide, nearly opaque Gaussians over the whole image: every alpha
    clips at 0.995, so the transmittance underflows fp32 after ~17."""
    rng = np.random.default_rng(seed)
    g = 40
    return jgs.GaussianScene(
        means=jnp.asarray(rng.uniform(-0.1, 0.1, (g, 3)), jnp.float32),
        log_scales=jnp.full((g, 3), np.log(20.0), jnp.float32),
        quats=jnp.asarray(rng.normal(size=(g, 4)), jnp.float32),
        colors=jnp.asarray(rng.normal(size=(g, 3)), jnp.float32),
        opacity_logits=jnp.full((g,), 12.0, jnp.float32))


CASES = {  # name: (renderer, per-tile budget K, background, scene, runs)
    # 300 entries in runs of 43, the last 42
    "dense_ragged_bg": ("dense", None, True, numpy_scene, 7),
    # kernels.splat_plan: 2 runs of 150
    "dense_plan": ("dense", None, False, numpy_scene, None),
    # 120 entries in runs of 18, the last 12
    "tiled_ragged": ("tiled", 120, False, numpy_scene, 7),
    # kernels.splat_plan: 3 runs of 100
    "tiled_plan_bg": ("tiled", 300, True, numpy_scene, None),
    # shorter than one run of the plan's (at least 128)
    "tiled_short_list_bg": ("tiled", 8, True, numpy_scene, None),
    "tiled_k1": ("tiled", 1, False, numpy_scene, None),
    # every alpha at 0.995: T underflows fp32 within the first run
    "underflow_dense_bg": ("dense", None, True, saturated_scene, 4),
    "underflow_tiled": ("tiled", 40, False, saturated_scene, 4),
}


class _Segments(torch.autograd.Function):
    """The segment algebra as a differentiable composite."""

    @staticmethod
    def forward(ctx, xy, abc, opac, color, background, geometry, runs):
        img, state = splat.composite_segments_plain(
            xy, abc, opac, color, background, *geometry, runs)
        ctx.save_for_backward(xy, abc, opac, color, background, state)
        ctx.geometry = geometry
        return img

    @staticmethod
    def backward(ctx, dout):
        grads = splat.composite_segments_bwd_plain(
            *ctx.saved_tensors, dout.contiguous(), *ctx.geometry)
        return (*grads, None, None)


def case(name, monkeypatch):
    """JAX's scene and render, and the port's, whose composite is the
    segment algebra."""
    kind, k, bg, make, runs = CASES[name]
    js, ts = both(make(1))
    jcam = jax_camera()
    tcam = camera_from_jax(jcam)
    jbg = jnp.asarray([0.2, 0.3, 0.4]) if bg else None
    tbg = torch.tensor([0.2, 0.3, 0.4]) if bg else None
    monkeypatch.setattr(
        splat, "composite",
        lambda xy, abc, opac, color, background, *geometry: _Segments.apply(
            xy, abc, opac, color, background, geometry, runs))
    if kind == "dense":
        return (js, lambda s: jgs.render(s, jcam, jbg),
                ts, lambda s: tgs.render(s, tcam, tbg),
                tgs.dense_lists(ts, tcam))
    return (js, lambda s: jgs.render_tiled(s, jcam, jbg, max_per_tile=k),
            ts, lambda s: tgs.render_tiled(s, tcam, tbg, max_per_tile=k),
            tgs.tile_lists(ts, tcam, max_per_tile=k))


@pytest.mark.parametrize("name", CASES)
def test_segment_image_matches_jax(name, monkeypatch):
    js, jrender, ts, trender, lists = case(name, monkeypatch)
    front, _ = in_front(js)
    ref = np.asarray(jax.jit(jrender)(front))
    got = trender(ts).detach().numpy()
    assert got.shape == (SIZE, SIZE, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the split the case names, and the kept state's shape and exponents
    runs = CASES[name][4]
    xy = lists.lists[0]
    k = xy.shape[1]
    _, state = splat.composite_segments_plain(*lists.lists, None,
                                              *lists.geometry, runs)
    want = runs or kernels.splat_plan(k, *lists.geometry[2:])[0]
    assert state.shape == (xy.shape[0], want, 5,
                           lists.geometry[2] * lists.geometry[3])
    if "ragged" in name:
        assert k % want and k % -(-k // want)
    if name.endswith("plan_bg"):
        assert want == 3
    if name == "tiled_short_list_bg":
        assert want == 1 and k < kernels.SPLAT_SEGMENT_MIN
    if name.startswith("underflow"):
        assert float(state[:, :, 1].min()) < -149  # below fp32's least T
        assert (state[:, :, 0] >= 0.5).all() and (state[:, :, 0] < 1).all()


@pytest.mark.parametrize("name", CASES)
def test_segment_gradients_match_jax(name, monkeypatch):
    js, jrender, ts, trender, _ = case(name, monkeypatch)
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
        assert np.isfinite(g.numpy()).all(), field
        assert np.abs(g.numpy()[keep] - r).max() <= 1e-4 * np.abs(r).max(), \
            field
        assert (g.numpy()[~keep] == 0).all(), field
