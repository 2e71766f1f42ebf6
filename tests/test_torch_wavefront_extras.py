"""The port's wavefront on the environment-lit, textured and cutout scenes
against the JAX package, on the CPU: frames, the coverage-aware shadow
march, CDF-search environment NEE and a one-sample pool (split from
tests/test_torch_megakernel_extras.py, whose scenes it shares, so that the
two files' JAX frames render on two workers).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.lights import environment as tenv
from test_torch_megakernel_extras import (  # noqa: F401  (a fixture)
    BOUNCES,
    DENSE,
    RES,
    _settings,
    jax_scenes,
)
from torch_parity import assert_statistical_gate


@pytest.fixture(scope="module")
def jax_wavefront():
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


# -- the wavefront --------------------------------------------------------------------

def _opacity_shadow_rays(n=2048):
    """Seeded shadow rays of the Opacity scene: from points on the floor and
    around the box towards points on the light inside the cutout box (they
    cross the 17 x 17 grid, sometimes a coverage-0.75 plane too), and from
    in front of the planes through them."""
    rng = np.random.default_rng(40)
    o = rng.uniform((-3.0, 0.01, -5.0), (3.0, 2.5, 2.0), size=(n, 3))
    target = np.asarray([0.0, 0.5, 0.0]) + rng.normal(scale=0.05, size=(n, 3))
    o[: n // 4] = rng.uniform((-0.5, 0.1, -5.5), (2.0, 1.9, -3.2),
                              size=(n // 4, 3))
    target[: n // 4, 2] += 0.2
    d = target - o
    dist = np.linalg.norm(d, axis=-1)
    d = d / dist[:, None]
    return (o.astype(np.float32), d.astype(np.float32),
            (dist * 0.98).astype(np.float32))


def test_shadow_transmittance_matches_jax(jax_scenes):
    jscene, _, scene, _ = jax_scenes("opacity")
    o, d, t_max = _opacity_shadow_rays()
    ref = np.asarray(jpt._shadow_transmittance(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jscene.scene_epsilon, 4))
    got = tpt._shadow_transmittance(
        scene, torch.tensor(o), torch.tensor(d), torch.tensor(t_max),
        scene.scene_epsilon, 4).numpy()
    # A ray through a texel border of the grid may read the other texel.
    same = np.isclose(got, ref, rtol=1e-5, atol=1e-6)
    assert same.mean() >= 0.995, 1 - same.mean()
    # The rays see all of it: open holes, grid lines, one and two planes.
    values = set(np.round(np.unique(ref), 4).tolist())
    assert {0.0, 0.25, 1.0} <= values, values
    coverage = np.asarray(jpt._coverage_at_hit(
        jscene, jax_hit := _first_hits(jscene, o, d)))
    port_cov = tpt._coverage_at_hit(scene, _port_hit(jax_hit)).numpy()
    np.testing.assert_allclose(port_cov, coverage, rtol=1e-6)


def _first_hits(jscene, o, d):
    from bifrost3d_tpu.geometry.traverse import intersect_scene
    return intersect_scene(jscene.bvh, jscene.tri_verts, jnp.asarray(o),
                           jnp.asarray(d), t_min=jscene.scene_epsilon,
                           tri_components=jscene.tri_components)


def _port_hit(jax_hit):
    from bifrost3d_tpu_torch.geometry.traverse import Hit
    return Hit(*(torch.tensor(np.asarray(a)) for a in jax_hit))


@pytest.mark.parametrize("entry", ["render_sample", "render_sample_pooled"])
@pytest.mark.parametrize("name", DENSE)
def test_wavefront_matches_jax(jax_scenes, jax_wavefront, name, entry):
    _, _, scene, cam = jax_scenes(name)
    ref = jax_wavefront(jax_scenes, name)
    img = getattr(tpt, entry)(scene, cam, RES, RES, 0, _settings(scene))
    assert_statistical_gate(img.numpy(), ref)
    assert float(img.mean()) > 1e-4


def test_cdf_search_nee_matches_jax(jax_scenes):
    """``use_presampled_environment=False``: the environment's candidate
    comes from a search of the CDFs."""
    jscene, jcam, scene, cam = jax_scenes("sphere_sun")
    jset = jpt.settings_for_scene(jscene, max_bounce_count=BOUNCES,
                                  use_presampled_environment=False)
    ref = np.asarray(jpt.render_sample(jscene, jcam, RES, RES, jnp.uint32(0),
                                       jset))
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES,
                                      use_presampled_environment=False)
    img = tpt.render_sample(scene, cam, RES, RES, 0, settings).numpy()
    assert_statistical_gate(img, ref)
    pooled = tpt.render_sample(scene, cam, RES, RES, 0, _settings(scene))
    assert float((pooled - torch.tensor(img)).abs().max()) > 1e-3


def test_one_sample_pool_disables_environment_nee(jax_scenes):
    _, _, scene, _ = jax_scenes("sphere_sun")
    pool = scene.environment_presampled
    one = tenv.PresampledEnvironmentLight(
        pool.light, pool.directions[:1], pool.radiances[:1], pool.pdfs[:1])
    settings = _settings(scene)
    assert tpt._environment_sampler(scene, settings) is not None
    assert tpt._environment_sampler(
        scene._replace(environment_presampled=one), settings) is None
    assert tpt._environment_sampler(
        scene._replace(environment=None), settings) is None
