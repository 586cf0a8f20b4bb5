"""The port's native host library (`sphereflake_tpu_torch/native/`, built
with the host C++ compiler at first use by
`sphereflake_tpu_torch/runtime/native.py`) against the reference
package's pure-Python implementations: `MT19937`, `direction_numbers`,
`sobol_sample_np` and `encode_png_python` (PNGs compared decoded, pixel
for pixel: the two encoders compress differently). Everything is exact.
The tests skip only where no C++ compiler exists."""

import os

import numpy as np
import pytest

from sphereflake_tpu.ops.noise import MT19937
from sphereflake_tpu.ops.sobol import (
    NUM_DIMENSIONS,
    direction_numbers,
    sobol_sample_np,
)
from sphereflake_tpu.utils.image import encode_png_python
from sphereflake_tpu_torch.runtime import native
from sphereflake_tpu_torch.utils import image as port_image

from test_native import _decode_png

needs_cxx = pytest.mark.skipif(
    native.find_cxx() is None, reason="no C++ compiler on this machine"
)


@needs_cxx
def test_library_is_built_from_the_port_sources_into_the_build_dir():
    lib = native.build()
    assert os.path.dirname(lib) == native.build_dir()
    assert os.path.basename(lib).startswith("libsphereflake_native_")
    assert native.build() == lib  # built once, then reused
    assert native.available()


@needs_cxx
def test_direction_numbers_match_reference():
    np.testing.assert_array_equal(
        native.sobol_direction_numbers(NUM_DIMENSIONS), direction_numbers()
    )
    with pytest.raises(ValueError, match="Joe-Kuo"):
        native.sobol_direction_numbers(NUM_DIMENSIONS + 1)


@pytest.mark.parametrize("base", [0, 1, 7, 1000, 2**33 - 5])
@needs_cxx
def test_sobol_batch_matches_reference(base):
    got = native.sobol_sample_batch(base, 64, 1)
    want = sobol_sample_np(np.arange(base, base + 64, dtype=np.uint64), 1)
    np.testing.assert_array_equal(got, want)


@needs_cxx
def test_sobol_scrambled_matches_reference():
    scr = (np.arange(32, dtype=np.uint64) * 2654435761 % 2**32).astype(
        np.uint32)
    got = native.sobol_sample_batch(5, 32, 0, scr)
    want = np.array([sobol_sample_np(np.array([i], np.uint64), 0, s)[0]
                     for i, s in zip(range(5, 37), scr)])
    np.testing.assert_array_equal(got, want)


@needs_cxx
def test_mt19937_matches_reference():
    want = MT19937(12512).draw(2000)
    np.testing.assert_array_equal(native.mt19937_draw(12512, 2000), want)
    np.testing.assert_array_equal(
        native.mt19937_draw(12512, 10, skip=1990), want[1990:]
    )


@needs_cxx
def test_png_decodes_to_the_reference_encoders_pixels():
    rng = np.random.default_rng(0)
    img = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    img[4:30, 3:40] = np.linspace(0, 200, 37, dtype=np.uint8)[None, :, None]
    ours = _decode_png(native.encode_png_native(img))
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(ours, _decode_png(encode_png_python(img)))
    with pytest.raises(ValueError, match="RGB8"):
        native.encode_png_native(img[..., :2])


@needs_cxx
def test_write_png_goes_through_the_native_encoder(tmp_path, monkeypatch):
    calls = []
    real = native.encode_png_native

    def counted(rgb):
        calls.append(rgb.shape)
        return real(rgb)

    monkeypatch.setattr(native, "encode_png_native", counted)
    img = np.linspace(0.0, 1.0, 24 * 16 * 3, dtype=np.float32).reshape(
        16, 24, 3)
    port_image.write_png(str(tmp_path / "a.png"), img)
    assert calls == [(16, 24, 3)]
    np.testing.assert_array_equal(
        _decode_png((tmp_path / "a.png").read_bytes()),
        port_image.to_uint8(img),
    )


def test_without_a_compiler_the_python_encoder_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    assert not native.available()
    img = np.zeros((4, 5, 3), np.uint8)
    img[1, 2] = (9, 8, 7)
    port_image.write_png(str(tmp_path / "p.png"), img)
    data = (tmp_path / "p.png").read_bytes()
    assert data == port_image.encode_png_python(img)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
