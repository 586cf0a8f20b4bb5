"""Shared helpers of the tests that hold the PyTorch port
(`sphereflake_tpu_torch`) against the JAX reference package
(`sphereflake_tpu`): both get the same inputs as NumPy arrays."""

import dataclasses

import numpy as np
import torch

from sphereflake_tpu_torch.convert import scene_from_numpy

# The plain versions of the kernels are loops of thousands of tiny eager
# ops; torch's intra-op thread pool only adds hand-over cost there, and
# with several test workers on one machine its spinning threads starve
# each other (a 20 s test took 15 minutes). One thread per worker.
torch.set_num_threads(1)


def scene_to_numpy(scene):
    """A reference `SceneParams` pytree as a nested dict of NumPy
    arrays, keyed by the leaf names both packages share."""
    return {
        group.name: {
            leaf.name: np.asarray(getattr(getattr(scene, group.name), leaf.name))
            for leaf in dataclasses.fields(getattr(scene, group.name))
        }
        for group in dataclasses.fields(scene)
    }


def port_scene(scene):
    """The port's CPU `SceneParams` holding the reference scene's leaves."""
    return scene_from_numpy(scene_to_numpy(scene), device="cpu")


def tree_to_numpy(d):
    """A dict of JAX arrays / Python ints as NumPy arrays / ints."""
    return {
        k: v if isinstance(v, int) else np.asarray(v) for k, v in d.items()
    }


def off_center(scene, dyaw=0.3, dpitch=0.2):
    """The reference scene with the camera turned off the fractal's
    centre (asymmetric projection intervals)."""
    cam = dataclasses.replace(
        scene.camera, yaw=scene.camera.yaw + dyaw,
        pitch=scene.camera.pitch + dpitch,
    )
    return dataclasses.replace(scene, camera=cam)
