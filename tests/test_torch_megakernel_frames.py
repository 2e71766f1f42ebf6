"""The plain version of the port's dense mesh megakernel against the JAX
package's ``render_sample`` on the very same scene arrays, on the CPU, and
the wavefront's per-lane Default/Diffuse select against JAX (split from
tests/test_torch_megakernel.py, whose scenes and helpers it shares, so that
the two files' JAX frames render on two workers).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from test_torch_megakernel import (  # noqa: F401  (jax_scenes: a fixture)
    BOUNCES,
    RES,
    _port_megakernel,
    jax_scenes,
)
from torch_parity import assert_statistical_gate


@pytest.fixture(scope="module")
def jax_render_sample():
    """name → JAX render_sample at accumulation 0, rendered once."""
    cache = {}

    def get(jax_scenes, name):
        if name not in cache:
            scene, cam, _, _ = jax_scenes(name)
            settings = jpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
            cache[name] = np.asarray(jpt.render_sample(
                scene, cam, RES, RES, jnp.uint32(0), settings))
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["veach", "veach_mesh_light", "spot",
                                  "diffuse", "emissive", "directional"])
def test_plain_megakernel_matches_jax_render_sample(jax_scenes,
                                                    jax_render_sample, name):
    _, _, scene, cam = jax_scenes(name)
    ref = jax_render_sample(jax_scenes, name)
    img, rays = _port_megakernel(scene, cam, 0)
    assert_statistical_gate(img, ref)
    assert img.mean() > 0.005 and rays > 0


@pytest.mark.parametrize("entry", ["render_sample", "render_sample_pooled"])
def test_wavefront_diffuse_matches_jax(jax_scenes, jax_render_sample, entry):
    """The wavefront's per-lane Default/Diffuse select against JAX."""
    _, _, scene, cam = jax_scenes("diffuse")
    assert scene.shading_models == (0, 1)
    ref = jax_render_sample(jax_scenes, "diffuse")
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    img = getattr(tpt, entry)(scene, cam, RES, RES, 0, settings)
    assert_statistical_gate(img.numpy(), ref)
