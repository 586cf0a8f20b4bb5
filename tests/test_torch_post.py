"""The port's post chain (texture samplers, SSAO, blur, composite,
`postprocess`, `render_frame`) vs the reference package on IDENTICAL
inputs made from NumPy seeds, and vs the NumPy transcriptions of the
GLSL in `models/golden_post.py`.

NEAREST taps are floor(u * size) of computed coordinates, so an ulp in a
coordinate can move a tap by one texel at a handful of pixels: image
comparisons state "fraction of pixels within atol" where taps are
data-dependent, as `tests/test_post.py` does against the golden."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import render as ref_render
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import SSAOParams as RefSSAO
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models import golden_post
from sphereflake_tpu.ops import noise as ref_noise
from sphereflake_tpu.ops import post as ref_post
from sphereflake_tpu.ops import texture as ref_texture
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.config import SSAOParams as PortSSAO
from sphereflake_tpu_torch.ops import noise as port_noise
from sphereflake_tpu_torch.ops import post as port_post
from sphereflake_tpu_torch.ops import texture as port_texture

from _torch_helpers import port_scene

T = torch.from_numpy


def _rand_gbuffer(h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(h, w, 3)).astype(np.float32) * 2.0
    pos[..., 2] -= 4.0  # plausible view-space z
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sky = rng.random((h, w)) < 0.15  # zero sentinel
    pos[sky] = 0.0
    nrm[sky] = 0.0
    return pos, nrm


def _ssao_params(**over):
    ref = dataclasses.replace(
        RefSSAO.reference_default(),
        **{k: jnp.float32(v) for k, v in over.items()},
    )
    port = dataclasses.replace(
        PortSSAO.reference_default("cpu"),
        **{k: torch.tensor(v, dtype=torch.float32) for k, v in over.items()},
    )
    return ref, port


def _frac_within(got, want, atol):
    return float((np.abs(np.asarray(got) - np.asarray(want)) <= atol).mean())


def test_noise_module_is_a_faithful_copy():
    assert list(port_noise.MT19937(5489).draw(5)) == [
        3499211612, 581869302, 3890346734, 3586334585, 545404204,
    ]
    np.testing.assert_array_equal(
        port_noise.MT19937(123).draw(1300), ref_noise.MT19937(123).draw(1300)
    )
    for size in (16, 64):
        np.testing.assert_array_equal(
            port_noise.ssao_noise_texture(size),
            ref_noise.ssao_noise_texture(size),
        )


@pytest.mark.parametrize(
    "name", ["sample_nearest_clamp", "sample_bilinear_clamp",
             "sample_bilinear_repeat"],
)
@pytest.mark.parametrize("channels", [None, 3], ids=["plane", "rgb"])
def test_samplers_match_reference(name, channels):
    """Same image and coordinates (out-of-range ones included): atol 1e-6."""
    rng = np.random.default_rng(1)
    shape = (7, 5) if channels is None else (7, 5, channels)
    img = rng.random(shape).astype(np.float32)
    us = (rng.random((6, 11)) * 1.6 - 0.3).astype(np.float32)
    vs = (rng.random((6, 11)) * 1.6 - 0.3).astype(np.float32)
    got = getattr(port_texture, name)(T(img), T(us), T(vs))
    want = getattr(ref_texture, name)(
        jnp.asarray(img), jnp.asarray(us), jnp.asarray(vs)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("downscale", [1, 2])
def test_ssao_matches_reference_and_glsl_transcription(downscale):
    pos, nrm = _rand_gbuffer()
    h, w = pos.shape[0] // downscale, pos.shape[1] // downscale
    noise = port_noise.ssao_noise_texture(16)
    ref_p, port_p = _ssao_params()
    radius = 3.7
    got = port_post.ssao_pass(
        T(pos), T(nrm), T(noise), port_p,
        (torch.tensor(radius), torch.tensor(1.0)), h, w,
    ).numpy()
    want = np.asarray(ref_post.ssao_pass(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(noise), ref_p,
        jnp.float32(radius), h, w,
    ))
    assert got.shape == (h, w)
    assert _frac_within(got, want, 1e-5) >= 0.99  # taps may move a texel
    assert np.abs(got - want).max() <= 0.2
    if downscale == 1:
        gold = golden_post.ssao_golden(
            pos, nrm, noise, float(ref_p.intensity), float(ref_p.scale),
            float(ref_p.bias), radius, h, w,
        )
        np.testing.assert_allclose(got, gold, atol=2e-4)


@pytest.mark.parametrize("gate", ["shipped", "open"])
@pytest.mark.parametrize("direction", [(1.0, 0.0), (0.0, 1.0)], ids=["h", "v"])
def test_blur_matches_reference_and_glsl_transcription(gate, direction):
    pos, nrm = _rand_gbuffer(seed=3)
    h, w = pos.shape[:2]
    src = np.random.default_rng(4).random((h, w)).astype(np.float32)
    # "open": a PASSABLE gate (threshold below 1) so both branches run.
    over = {} if gate == "shipped" else dict(
        normal_threshold=-2.0, depth_threshold=0.05
    )
    ref_p, port_p = _ssao_params(**over)
    got = port_post.blur_pass(
        T(src), T(pos), T(nrm), port_p, direction, h, w
    ).numpy()
    want = np.asarray(ref_post.blur_pass(
        jnp.asarray(src), jnp.asarray(pos), jnp.asarray(nrm), ref_p,
        direction, h, w,
    ))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    gold = golden_post.blur_golden(
        src, pos, nrm, float(ref_p.normal_threshold),
        float(ref_p.depth_threshold), direction, h, w,
    )
    np.testing.assert_allclose(got, gold, atol=2e-5)


def test_reference_blur_gate_never_passes():
    """With the shipped normalThreshold = 2.47 no tap can pass the gate
    (a unit-normal dot is <= 1), so the blur folds to the source times
    the weight sum 0.9998 (`post_ssao_blur.glsl:30,46-65`) — the quirk
    is preserved, not fixed."""
    pos, nrm = _rand_gbuffer(seed=5)
    h, w = pos.shape[:2]
    src = np.random.default_rng(6).random((h, w)).astype(np.float32)
    out = port_post.blur_pass(
        T(src), T(pos), T(nrm), PortSSAO.reference_default("cpu"),
        (1.0, 0.0), h, w,
    ).numpy()
    weight = sum(port_post._BLUR_WEIGHT[i] for i in (0, 1, 1, 2, 2))
    np.testing.assert_allclose(out, src * weight, atol=1e-5)
    assert port_post._BLUR_WEIGHT == ref_post._BLUR_WEIGHT
    assert port_post._BLUR_OFFSET == ref_post._BLUR_OFFSET
    np.testing.assert_array_equal(port_post._KERNEL, ref_post._KERNEL)


def test_composite_matches_reference_and_glsl_transcription():
    pos, _ = _rand_gbuffer(seed=7)
    h, w = pos.shape[:2]
    ao = np.random.default_rng(8).random((h, w)).astype(np.float32)
    cam = np.array([0.3, -0.2, 1.4], np.float32)
    # the frame's composite runs inside `blur_composite_pass`, on planes
    # sampled at the pixel's own texel: `_shade` on the planes themselves
    got = port_post._shade(T(pos), T(ao), T(cam)).numpy()
    want = np.asarray(ref_post.composite_pass(
        jnp.asarray(pos), jnp.asarray(ao), jnp.asarray(cam), h, w
    ))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, golden_post.composite_golden(pos, ao, cam, h, w), atol=1e-5
    )
    assert (got[np.linalg.norm(pos, axis=-1) == 0] == 0).all()  # sky is black


def test_block_fragcoord_matches_reference():
    got = port_post.block_fragcoord(4, 6, 8, 16, "cpu")
    want = ref_post.block_fragcoord(4, 6, 8, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("downscale", [1, 2])
def test_postprocess_matches_reference_on_identical_gbuffer(downscale):
    """The reference's own rendered G-buffer goes through both post
    chains: >= 99.9 % of pixels within 1e-5, none off by more than the
    SSAO term can move one (0.2)."""
    scene = default_scene()
    kw = dict(width=128, height=96, max_depth=2, tile_h=32, tile_w=32,
              algorithm="binned", ssao_downscale=downscale)
    gb = ref_render.render_gbuffer(scene, RefConfig(**kw))
    noise = port_noise.ssao_noise_texture(64)
    want = np.asarray(ref_post.postprocess(
        gb.position, gb.normal, gb.metrics.closest_distance, scene,
        RefConfig(**kw), jnp.asarray(noise),
    ))
    got = port_post.postprocess(
        T(np.array(gb.position)), T(np.array(gb.normal)),
        torch.tensor(float(gb.metrics.closest_distance)),
        port_scene(scene), PortConfig(**kw), T(noise),
    ).numpy()
    assert got.shape == (96, 128, 3) and np.isfinite(got).all()
    assert _frac_within(got, want, 1e-5) >= 0.999
    assert np.abs(got - want).max() <= 0.2


def test_render_frame_end_to_end_matches_reference():
    """The slice as a whole: the port's `render_frame` on the CPU vs the
    reference's (binned, kernel interpreted). Pixels differ where a
    silhouette graze flipped or an SSAO tap moved: >= 99 % of pixels
    within 2e-3, sky black on both, mean brightness within 1 %."""
    scene = default_scene()
    kw = dict(width=128, height=96, max_depth=2, tile_h=32, tile_w=32,
              algorithm="binned")
    want_img, want_gb = ref_render.render_frame(scene, RefConfig(**kw))
    image, gb = port_render.render_frame(
        port_scene(scene), PortConfig(**kw), device="cpu"
    )
    got, want = image.numpy(), np.asarray(want_img)
    assert got.shape == (96, 128, 3) and np.isfinite(got).all()
    hit = gb.hit.numpy()
    assert (hit == np.asarray(want_gb.hit)).mean() >= 0.999
    assert np.abs(got[~hit]).max() == 0.0
    assert got[hit].mean() > 0.05
    assert _frac_within(got, want, 2e-3) >= 0.99
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
