"""The port's geometry modules (transforms, fractal frames, camera) vs
the reference package on the same inputs. torch's and XLA's
sin/cos/tan differ by ulps, so everything here is held to atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import camera as ref_camera
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models import sphereflake as ref_model
from sphereflake_tpu.ops import intersect as ref_intersect
from sphereflake_tpu.ops import transforms as ref_tf
from sphereflake_tpu_torch import camera as port_camera
from sphereflake_tpu_torch.models import sphereflake as port_model
from sphereflake_tpu_torch.ops import intersect as port_intersect
from sphereflake_tpu_torch.ops import transforms as port_tf

from _torch_helpers import off_center, port_scene

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=0, atol=atol
    )


def _rng_angles(n, seed):
    return np.random.default_rng(seed).uniform(-4, 4, n).astype(np.float32)


@pytest.mark.parametrize("name", ["rotation_x", "rotation_y", "rotation_z"])
def test_axis_rotations(name):
    a = _rng_angles(17, 0)
    _close(getattr(port_tf, name)(torch.from_numpy(a)),
           getattr(ref_tf, name)(jnp.asarray(a)))


def test_euler_and_look_rotation():
    deg = np.random.default_rng(1).uniform(-360, 360, (11, 3)).astype(np.float32)
    _close(port_tf.euler_xyz_rotation(torch.from_numpy(deg)),
           ref_tf.euler_xyz_rotation(jnp.asarray(deg)))
    y, p, r = (float(v) for v in _rng_angles(3, 2))
    _close(
        port_tf.look_rotation(torch.tensor(y), torch.tensor(p), torch.tensor(r)),
        ref_tf.look_rotation(jnp.float32(y), jnp.float32(p), jnp.float32(r)),
    )


def test_spherical_normalize_and_frames():
    rng = np.random.default_rng(3)
    lon, lat = _rng_angles(9, 4), _rng_angles(9, 5)
    _close(port_tf.spherical_to_world(torch.from_numpy(lon), torch.from_numpy(lat)),
           ref_tf.spherical_to_world(jnp.asarray(lon), jnp.asarray(lat)))
    v = rng.normal(size=(13, 3)).astype(np.float32)
    _close(port_tf.normalize(torch.from_numpy(v)), ref_tf.normalize(jnp.asarray(v)))
    a = rng.normal(size=(5, 3, 4)).astype(np.float32)
    b = rng.normal(size=(5, 3, 4)).astype(np.float32)
    _close(port_tf.rt_multiply(torch.from_numpy(a), torch.from_numpy(b)),
           ref_tf.rt_multiply(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)
    _close(port_tf.rt_translation(torch.from_numpy(a)), ref_tf.rt_translation(a))
    _close(port_tf.compose_rt(torch.from_numpy(a[..., :3]), torch.from_numpy(a[..., 3])),
           ref_tf.compose_rt(jnp.asarray(a[..., :3]), jnp.asarray(a[..., 3])))


def test_safe_sqrt():
    x = np.array([-1.0, 0.0, 1e-30, 2.0, 9.0], np.float32)
    _close(port_intersect.safe_sqrt(torch.from_numpy(x)),
           ref_intersect.safe_sqrt(jnp.asarray(x)), atol=0)


def test_fractal_frames():
    scene = default_scene()
    port = port_scene(scene)
    _close(port_model.child_templates(port.fractal),
           ref_model.child_templates(scene.fractal))
    _close(port_model.root_frame(port.camera.position),
           ref_model.root_frame(scene.camera.position))
    for level in (0, 1, 5, 13):
        _close(port_model.level_radius(port.fractal, level),
               ref_model.level_radius(scene.fractal, level), atol=1e-9)


@pytest.mark.parametrize("pose", ["reference", "off_center"])
def test_camera_rays(pose):
    scene = default_scene() if pose == "reference" else off_center(default_scene())
    port = port_scene(scene)
    for got, want in zip(port_camera.corner_rays(port.camera, 128 / 96),
                         ref_camera.corner_rays(scene.camera, 128 / 96)):
        _close(got, want, atol=2e-6)
    xs, ys = port_camera.pixel_grid(128, 96, device="cpu")
    rxs, rys = ref_camera.pixel_grid(128, 96)
    _close(xs, rxs, atol=0)
    _close(ys, rys, atol=0)
    _close(port_camera.ray_directions(port.camera, xs, ys, 128, 96),
           ref_camera.ray_directions(scene.camera, rxs, rys, 128, 96))
    _close(port_camera.camera_scaling(port.camera.fov),
           ref_camera.camera_scaling(scene.camera.fov), atol=1e-7)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(x_off=32.0, y_off=64.0, block_h=32, block_w=96)],
    ids=["frame", "block"],
)
def test_tile_frustum_planes(kw):
    scene = off_center(default_scene())
    port = port_scene(scene)
    _close(
        port_camera.tile_frustum_planes(port.camera, 128, 96, 32, 32, **kw),
        ref_camera.tile_frustum_planes(scene.camera, 128, 96, 32, 32, **kw),
        atol=5e-6,
    )
