"""The port's configuration and parameter containers vs the reference
package's: `RenderConfig` must size every table identically."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from sphereflake_tpu import config as ref_config
from sphereflake_tpu_torch import config as port_config

from _torch_helpers import port_scene, scene_to_numpy

_PROPS = (
    "pair_cap", "effective_band_rows", "padded_width", "padded_height",
    "tiles_x", "tiles_y", "aspect",
)

_GRID = [
    dict(width=w, height=h, max_depth=d, global_cap=g, algorithm="binned",
         tile_h=th, tile_w=tw, band_tile_rows=b)
    for (w, h), d, g, (th, tw), b in itertools.product(
        [(128, 96), (100, 60), (1920, 1080), (4096, 4096)],
        [0, 3, 6, 7, 9, 13],
        [9 << 13, 1 << 15, 9 << 16],
        [(32, 32), (8, 128)],
        [None, 1],
    )
]


@pytest.mark.parametrize("chunk", range(6))
def test_render_config_properties_agree(chunk):
    """Exact equality of every derived property over a grid of binned
    configs (sizes, depths, caps, tiles, banding)."""
    for kw in _GRID[chunk::6]:
        ref = ref_config.RenderConfig(**kw)
        port = port_config.RenderConfig(**kw)
        for prop in _PROPS:
            assert getattr(port, prop) == getattr(ref, prop), (prop, kw)


def test_render_config_fields_and_defaults_agree():
    ref_fields = {
        f.name: f.default for f in dataclasses.fields(ref_config.RenderConfig)
    }
    port_fields = {
        f.name: f.default for f in dataclasses.fields(port_config.RenderConfig)
    }
    assert port_fields == ref_fields


@pytest.mark.parametrize(
    "kw",
    [
        dict(algorithm="binned", tile_h=64, tile_w=128),
        dict(algorithm="pallas", tile_h=16, tile_w=32),
        dict(algorithm="fast", width=100, height=60),
        dict(algorithm="binned", tile_h=32, tile_w=32, max_depth=14),
        dict(algorithm="binned", tile_h=32, tile_w=32, max_depth=-1),
        dict(algorithm="fast", band_tile_rows=1),
        dict(algorithm="binned", tile_h=32, tile_w=32, width=128, height=96,
             band_tile_rows=2),
    ],
    ids=["tile-size", "pallas-tile", "indivisible", "too-deep", "negative",
         "bands-need-binned", "bands-divide"],
)
def test_render_config_errors_agree(kw):
    """Both packages reject the same configs with the same message."""
    with pytest.raises(ValueError) as ref_err:
        ref_config.RenderConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        port_config.RenderConfig(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_default_scene_leaves_equal():
    ref = scene_to_numpy(ref_config.default_scene())
    port = port_config.default_scene(device="cpu")
    for group, leaves in ref.items():
        for name, want in leaves.items():
            got = getattr(getattr(port, group), name)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_scene_from_numpy_round_trip():
    ref = ref_config.default_scene()
    port = port_scene(ref)
    np.testing.assert_array_equal(
        port.fractal.child_rotations_deg.numpy(),
        np.asarray(ref.fractal.child_rotations_deg),
    )
    assert port.device.type == "cpu"


def test_cuda_device_without_cuda_raises():
    """Asking for the card on a machine without one is an error, never a
    silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        port_config.default_scene()  # default device is "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        port_config.resolve_device("cuda:0")
