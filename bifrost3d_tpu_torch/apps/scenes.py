"""Built-in test scenes.

Port of ``bifrost3d_tpu/apps/scenes.py`` (``_trs``,
``create_cornell_box``, ``create_material_scene``,
``create_legacy_material_scene``, ``create_veach_scene``,
``create_sphere_scene``, ``create_sphere_light_scene``,
``create_glass_scene``, ``_checkered_floor_parts``,
``create_opacity_scene``, ``create_test_scene``, ``SCENES``). Each builder
takes JAX's parameters in JAX's order, then the port's own keyword-only
(``device`` among them), and returns (RenderScene, PinholeCamera) on that
device. ``create_material_scene`` loads the Mori shader ball from
``SHADERBALL_PATH`` (``BIFROST_SHADERBALL``, as in JAX) through the port's
own glTF loader, and builds JAX's spheres where the asset is missing.

``TEST_SCENES`` holds the small scenes that the JAX package's megakernel
tests build inline (``tests/test_pallas_mesh.py``: coated materials, a
spot light, Default and Diffuse materials side by side), one with an
emissive panel and one lit by a directional and a sphere light; each
exercises a branch of the megakernel that the
built-in scenes leave out. It also holds ``torus_grid``, the JAX package's
own large scene (``bench.py::bench_torus_grid``: an 8 × 8 grid of tori,
589,824 triangles) given the material, light and camera a frame needs: it
is over the dense kernel's 65,536 triangles and renders through the BVH
trace kernel. Between the dense megakernel's 1,024 triangles and the
megakernel's cap of 262,144 sit ``mid_size`` (the JAX package's
``tests/test_pallas_mesh.py::_mid_size_scene``, 2,494 triangles), the three
``hier_bridge`` scenes of ``bench.py::bench_hier_bridge`` (3,054, 14,606 and
49,678 triangles) and ``torus_grid_28``, the first 28 tori of the grid
(258,048 triangles): they render through the megakernel's BVH branch.

Four more drive the megakernel's environment, texture and cutout branches:
``textured_cornell`` (``tests/test_pallas_mesh.py:84-120``: a box over the
checkered floor), ``sphere_sun`` (the Sphere scene under a map that is not
uniform), and on the BVH branch ``hier_bridge_15k_env`` (that map over the
14,606-triangle bridge scene) and ``opacity_hier`` (Opacity plus a
2,494-triangle sphere of the cutout material).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.creation import (
    make_box,
    make_plane,
    make_sphere,
    make_torus,
)
from bifrost3d_tpu_torch.geometry.mesh import combine_meshes, transform_mesh
from bifrost3d_tpu_torch.geometry.native import REPO_DIR
from bifrost3d_tpu_torch.io.gltf import load_gltf
from bifrost3d_tpu_torch.io.texture import FILTER_NONE, TextureBank
from bifrost3d_tpu_torch.lights.types import (
    LIGHT_DIRECTIONAL,
    LIGHT_SPHERE,
    LIGHT_SPOT,
    LightArray,
)
from bifrost3d_tpu_torch.math.color import srgb_to_linear
from bifrost3d_tpu_torch.math.quaternion import (
    quat_from_axis_angle,
    quat_to_matrix,
)
from bifrost3d_tpu_torch.scene.camera import perspective_camera
from bifrost3d_tpu_torch.scene.materials import (
    COPPER_TINT,
    FLAG_CUTOUT,
    FLAG_THIN_WALLED,
    GOLD_TINT,
    IRON_TINT,
    MaterialArray,
    dielectric,
    metal,
    transmissive,
)
from bifrost3d_tpu_torch.scene.render_scene import build_render_scene

F32 = np.float32
PI = float(np.pi)
HALF_PI = PI / 2


def _trs(translation=(0, 0, 0), axis=None, angle=0.0, scale=1.0):
    """3x4 affine from translation + axis-angle + uniform scale (float32)."""
    if axis is None:
        rot = np.eye(3, dtype=F32)
    else:
        q = quat_from_axis_angle(torch.tensor(axis, dtype=torch.float32),
                                 torch.tensor(angle, dtype=torch.float32))
        rot = quat_to_matrix(q).numpy().astype(F32)
    m = np.zeros((3, 4), F32)
    m[:, :3] = rot * scale
    m[:, 3] = translation
    return m


def create_cornell_box(environment_map=None, aspect=1.0, *, device):
    """CornellBox.h:23-120: red/green/white thin-walled 1-unit room, iron
    small box, copper tall box, sphere light (power 2, r 0.05) at the
    ceiling; ``environment_map`` [h, w, 3] lights it from outside."""
    mats = MaterialArray.build([
        dielectric((0.98, 0.98, 0.98), 1.0, 0.02, flags=FLAG_THIN_WALLED),
        dielectric((0.98, 0.02, 0.02), 1.0, 0.02, flags=FLAG_THIN_WALLED),
        dielectric((0.02, 0.98, 0.02), 1.0, 0.02, flags=FLAG_THIN_WALLED),
        metal(IRON_TINT, 0.4),
        metal(COPPER_TINT, 0.02),
    ], device=device)
    plane = make_plane(size=1.0)
    box = make_box(size=1.0)
    tall_box = transform_mesh(box, np.asarray(
        [[1, 0, 0, 0], [0, 2, 0, 0], [0, 0, 1, 0]], F32))

    forward = (0, 0, 1)
    right = (1, 0, 0)
    up = (0, 1, 0)
    instances = [
        (plane, 0, _trs((0, -0.5, 0))),                              # floor
        (plane, 0, _trs((0, 0.5, 0), forward, PI)),                  # roof
        (plane, 0, _trs((0, 0, 0.5), right, -HALF_PI)),              # back
        (plane, 1, _trs((-0.5, 0, 0), forward, -HALF_PI)),           # left red
        (plane, 2, _trs((0.5, 0, 0), forward, HALF_PI)),             # right green
        (box, 3, _trs((0.2, -0.35, -0.2), up, PI / 6, 0.3)),         # iron box
        (tall_box, 4, _trs((-0.2, -0.2, 0.2), up, -PI / 6, 0.3)),    # copper box
    ]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0.0, 0.45, 0.0), "radius": 0.05,
         "power": (2.0, 2.0, 2.0)}], device=device)
    scene = build_render_scene(instances, mats, lights,
                               environment_map=environment_map, device=device)
    camera = perspective_camera(eye=(0, 0, -1.5), target=(0, 0, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


# The Mori shader ball of the Bifrost3D sources
# (apps/SimpleViewer/Resources/Shaderball.gltf). Without
# ``BIFROST_SHADERBALL``, ``assets/Shaderball.gltf`` in the repository,
# where the asset goes once the repository holds it: a default inside the
# checkout, so that what lies around it never changes the scene.
SHADERBALL_PATH = os.environ.get(
    "BIFROST_SHADERBALL", os.path.join(REPO_DIR, "assets", "Shaderball.gltf"))

MATERIAL_SCENE_COUNT = 7  # MaterialGUI::material_count (Material.cpp:20)
# The teal dielectric and the gold metal that both material scenes sweep
# between.
_MATERIAL_SWEEP = (
    dict(tint=(0.02, 0.27, 0.33), roughness=1.0, specularity=0.04,
         metallic=0.0),
    dict(tint=GOLD_TINT, roughness=0.02, specularity=0.04, metallic=1.0))


def _material_sweep(n):
    """``n`` materials lerping the teal dielectric to gold metal."""
    mat0, mat1 = _MATERIAL_SWEEP
    out = []
    for m in range(n):
        t = m / (n - 1.0)
        out.append(dict(
            tint=tuple(np.asarray(mat0["tint"]) * (1 - t)
                       + np.asarray(mat1["tint"]) * t),
            roughness=mat0["roughness"] * (1 - t) + mat1["roughness"] * t,
            specularity=0.04, metallic=t))
    return out


def _material_scene_light(device):
    """Directional light from (20, 20, -20) toward the origin
    (Material.cpp:141-146), radiance (3, 2.9, 2.5)."""
    ldir = -np.asarray([20.0, 20.0, -20.0], F32)
    ldir /= np.linalg.norm(ldir)
    return LightArray.build([
        {"kind": LIGHT_DIRECTIONAL, "direction": tuple(ldir),
         "radiance": (3.0, 2.9, 2.5)}], device=device)


def _load_shader_ball_meshes():
    """Scenes/Utils.cpp load_shader_ball: keep Node5 (outside, gets the
    test material) and Node2 (inside, rubber); drop the rest. Returns
    (outside_mesh, inside_mesh), or None when the asset or either node is
    missing. Reads ``SHADERBALL_PATH`` at call time."""
    if not os.path.exists(SHADERBALL_PATH):
        return None
    meshes = load_gltf(SHADERBALL_PATH, load_textures=False)[0]
    by_name = {name: mesh for mesh, _, name in meshes}
    if "Node5" not in by_name or "Node2" not in by_name:
        return None
    return by_name["Node5"], by_name["Node2"]


def create_material_scene(environment_map=None, aspect=1.0, *, device):
    """Material.cpp create_material_scene: seven Mori shader balls sweeping
    from a teal dielectric (roughness 1) to gold metal (roughness 0.02),
    rubber inside, on the checkered floor, lit by one directional light.
    Without the shader-ball asset, spheres (32 × 16) stand where the balls
    would, as in JAX."""
    floor_mesh, floor_mat, floor_tex = _checkered_floor_parts()
    textures = TextureBank.build([floor_tex], device=device)
    floor_mat["tint_roughness_texture"] = 0
    n = MATERIAL_SCENE_COUNT
    mats = MaterialArray.build(
        [floor_mat, dielectric((0.05, 0.05, 0.05), 1.0)]
        + _material_sweep(n), device=device)

    instances = [(floor_mesh, 0, _trs((0, -1.0, 0)))]
    ball = _load_shader_ball_meshes()
    spacing = 1.2
    x0 = -spacing * 0.5 * (n - 1)
    for m in range(n):
        x = x0 + m * spacing
        if ball is not None:
            outside, inside = ball
            instances.append((outside, 2 + m, _trs((x, 0, 0), scale=2.0)))
            instances.append((inside, 1, _trs((x, 0, 0), scale=2.0)))
        else:
            instances.append((make_sphere(radius=0.5, slices=32, stacks=16),
                              2 + m, _trs((x, 0.0, 0))))
    scene = build_render_scene(instances, mats, _material_scene_light(device),
                               environment_map=environment_map,
                               textures=textures, device=device)
    camera = perspective_camera(eye=(0, 5.5, -18.5), target=(0, 0.5, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_legacy_material_scene(aspect=1.0, box_size=1.0,
                                 sphere_radius=0.5, spacing=1.2,
                                 floor_tint=(0.72, 0.72, 0.72),
                                 floor_roughness=0.08,
                                 checker_size=0.60,
                                 floor_shift=(0.0, 0.10),
                                 eye=(0.0, 1.2, -10.8),
                                 target=(0.0, 0.35, 0.0), *, device):
    """The earlier MaterialScene: nine spheres on boxes sweeping the teal
    dielectric to gold metal over the checkered floor, one directional
    light (the revision the reference's MaterialScene_2048.png shows)."""
    n = 9
    floor_mesh, floor_mat, floor_tex = _checkered_floor_parts(
        checker_size=checker_size, tint=floor_tint,
        roughness=floor_roughness)
    textures = TextureBank.build([floor_tex], device=device)
    floor_mat["tint_roughness_texture"] = 0
    mats = MaterialArray.build([floor_mat] + _material_sweep(n),
                               device=device)

    instances = [(floor_mesh, 0,
                  _trs((floor_shift[0], -1.0, floor_shift[1])))]
    x0 = -spacing * 0.5 * (n - 1)
    box_y = -1.0 + box_size * 0.5
    sphere_y = -1.0 + box_size + sphere_radius
    for m in range(n):
        x = x0 + m * spacing
        instances.append((make_box(size=box_size), 1 + m,
                          _trs((x, box_y, 0))))
        instances.append((make_sphere(radius=sphere_radius, slices=32,
                                      stacks=16), 1 + m,
                          _trs((x, sphere_y, 0))))
    scene = build_render_scene(instances, mats, _material_scene_light(device),
                               textures=textures, device=device)
    camera = perspective_camera(eye=eye, target=target, fov_radians=PI / 4,
                                aspect=aspect, device=device)
    return scene, camera


def create_veach_scene(with_mesh_light: bool = False, aspect=1.0, *, device):
    """Veach.h:27: the classic MIS scene — four increasingly rough plates
    reflecting three sphere lights of increasing size and equal power.
    ``with_mesh_light`` is accepted and, as in the JAX builder, changes
    nothing."""
    material_dicts = [dielectric((0.4, 0.4, 0.4), 0.9)]
    instances = [
        (make_plane(size=40.0), 0, _trs((0, 0, 0))),
        (make_plane(size=40.0), 0, _trs((0, 0, -10), (1, 0, 0), -HALF_PI)),
    ]
    plate = transform_mesh(make_plane(size=1.0), np.asarray(
        [[4.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1.0, 0]], F32))
    for i, rough in enumerate([0.005, 0.02, 0.05, 0.1]):
        material_dicts.append(metal((0.9, 0.9, 0.9), rough))
        angle = 0.25 + 0.18 * i
        instances.append((plate, len(material_dicts) - 1,
                          _trs((0, 0.25 + 0.5 * i, -1.0 - 1.05 * i),
                               (1, 0, 0), -angle)))
    mats = MaterialArray.build(material_dicts, device=device)
    power = (30.0, 30.0, 30.0)
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (-2.5, 5.0, -6.0), "radius": 0.03,
         "power": power},
        {"kind": LIGHT_SPHERE, "position": (0.0, 5.0, -6.0), "radius": 0.3,
         "power": power},
        {"kind": LIGHT_SPHERE, "position": (2.5, 5.0, -6.0), "radius": 0.9,
         "power": power},
    ], device=device)
    scene = build_render_scene(instances, mats, lights, device=device)
    camera = perspective_camera(eye=(0, 3.0, 3.0), target=(0, 1.8, -3.0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_sphere_scene(aspect=1.0, *, environment_map=None, device):
    """Sphere.h: a single sphere on a plane under an environment, by default
    a constant 0.8 map of 16 x 32 texels; the pool holds 8,192 samples."""
    mats = MaterialArray.build([
        dielectric((0.5, 0.5, 0.5), 0.8),
        dielectric((0.8, 0.2, 0.2), 0.3)], device=device)
    instances = [
        (make_plane(size=20.0), 0, _trs((0, -0.5, 0))),
        (make_sphere(radius=0.5), 1, _trs((0, 0, 0)))]
    if environment_map is None:
        environment_map = np.full((16, 32, 3), 0.8, F32)
    scene = build_render_scene(instances, mats,
                               environment_map=environment_map,
                               presample_environment=8192, device=device)
    camera = perspective_camera(eye=(0, 0.5, -2.5), target=(0, 0, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_sphere_light_scene(aspect=1.0, *, device):
    """SphereLight.h: a diffuse 960-triangle sphere lit by a large nearby
    sphere light."""
    mats = MaterialArray.build([dielectric((0.8, 0.8, 0.8), 0.7)],
                               device=device)
    instances = [(make_sphere(radius=0.5), 0, _trs((0, 0, 0)))]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (1.5, 1.0, -1.0), "radius": 0.5,
         "power": (40.0, 40.0, 40.0)}], device=device)
    scene = build_render_scene(instances, mats, lights, device=device)
    camera = perspective_camera(eye=(0, 0.5, -2.5), target=(0, 0, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_glass_scene(aspect=1.0, *, device):
    """GlassScene.h analogue: a smooth and a rough transmissive sphere over
    a floor, a sphere light and a constant 0.3 environment."""
    mats = MaterialArray.build([
        dielectric((0.6, 0.6, 0.6), 0.9),
        transmissive((0.95, 0.95, 0.95), 0.0),
        transmissive((0.9, 0.5, 0.4), 0.15)], device=device)
    instances = [
        (make_plane(size=20.0), 0, _trs((0, -0.5, 0))),
        (make_sphere(radius=0.5), 1, _trs((-0.7, 0.0, 0))),
        (make_sphere(radius=0.5), 2, _trs((0.7, 0.0, 0)))]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0, 4.0, -2.0), "radius": 0.5,
         "power": (150.0, 150.0, 150.0)}], device=device)
    scene = build_render_scene(
        instances, mats, lights,
        environment_map=np.full((16, 32, 3), 0.3, F32),
        presample_environment=8192, device=device)
    camera = perspective_camera(eye=(0, 0.6, -3.0), target=(0, 0, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def _checkered_floor_parts(floor_size=400.0, checker_size=1.0,
                           tint=(0.02, 0.27, 0.33), roughness=0.3):
    """Scenes/Utils.cpp create_checkered_floor: a thin-walled plane with a
    2x2 sRGB checker tint-roughness texture repeated across the floor →
    (mesh, material dict, texture dict)."""
    checker = np.zeros((2, 2, 4), F32)
    for y in range(2):
        for x in range(2):
            is_black = (x & 1) != (y & 1)
            intensity = 1 / 255.0 if is_black else 1.0
            checker[y, x, :3] = float(srgb_to_linear(intensity))
            checker[y, x, 3] = 15 / 255.0 if is_black else 1.0
    texture = {"image": checker, "filter": FILTER_NONE}

    mesh = make_plane(size=floor_size)
    # Texcoords match the checker size, centred for precision
    # (Utils.cpp: uv_scale = floor_size / (2 * checker_size)).
    uv_scale = floor_size / (2.0 * checker_size)
    mesh = mesh._replace(
        texcoords=(np.asarray(mesh.texcoords) - 0.5) * uv_scale)
    material = dict(tint=tint, roughness=roughness, flags=FLAG_THIN_WALLED)
    return mesh, material, texture


def create_opacity_scene(aspect=1.0, *, extra_instances=(), device):
    """Opacity.h: checkered floor, a 0.1-radius sphere light inside a
    17x17-grid cutout box ("Swizz box"), and two thin-walled coverage-0.75
    planes in front (Opacity.h:27-107). ``extra_instances`` are appended;
    material 1 is the cutout."""
    floor_mesh, floor_mat, floor_tex = _checkered_floor_parts()

    # 17x17 Alpha8 grid: opaque lines, holes in the cell centres
    # (Opacity.h:57-68); sampled with nearest filtering.
    grid = np.zeros((17, 17, 1), F32)
    for y in range(17):
        for x in range(17):
            grid[y, x, 0] = 1.0 if ((x & 1) == 0 or (y & 1) == 0) else 0.0

    textures = TextureBank.build([
        floor_tex, {"image": grid, "filter": FILTER_NONE}], device=device)

    floor_mat["tint_roughness_texture"] = 0
    mats = MaterialArray.build([
        floor_mat,
        dict(tint=(0.005, 0.01, 0.25), roughness=0.05, coverage=1.0,
             flags=FLAG_CUTOUT, coverage_texture=1),
        dict(tint=(0.25, 0.25, 0.25), roughness=0.95, coverage=0.75,
             flags=FLAG_THIN_WALLED)], device=device)

    plane = make_plane(size=1.0)
    instances = [
        (floor_mesh, 0, _trs((0, -0.0005, 0))),
        (make_box(size=1.0), 1, _trs((0, 0.5, 0))),
        (plane, 2, _trs((1.0, 1.0, -2.0), (1, 0, 0), HALF_PI, 2.0)),
        (plane, 2, _trs((0.0, 0.25, -3.0), (1, 0, 0), HALF_PI, 1.0)),
        *extra_instances]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0, 0.5, 0), "radius": 0.1,
         "power": (50.0, 50.0, 50.0)}], device=device)
    scene = build_render_scene(instances, mats, lights, textures=textures,
                               device=device)
    camera = perspective_camera(eye=(0, 1.0, -6.0), target=(0, 1.0, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_test_scene(aspect=1.0, *, device):
    """TestScene.h analogue: a mixed-material still life (a diffuse floor,
    a gold sphere, a coated box and a glass sphere)."""
    mats = MaterialArray.build([
        dielectric((0.6, 0.6, 0.6), 0.9),
        metal(GOLD_TINT, 0.3),
        dielectric((0.2, 0.4, 0.8), 0.1, coat=1.0, coat_roughness=0.0),
        transmissive((0.95, 0.95, 0.95), 0.05)], device=device)
    instances = [
        (make_plane(size=20.0), 0, _trs((0, -0.5, 0))),
        (make_sphere(radius=0.4), 1, _trs((-1.0, -0.1, 0.3))),
        (make_box(size=0.7), 2, _trs((0.1, -0.15, 0.5), (0, 1, 0), 0.5)),
        (make_sphere(radius=0.4), 3, _trs((1.1, -0.1, -0.2)))]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (2, 4.0, -3.0), "radius": 0.4,
         "power": (200.0, 200.0, 200.0)}], device=device)
    scene = build_render_scene(
        instances, mats, lights,
        environment_map=np.full((16, 32, 3), 0.25, F32),
        presample_environment=8192, device=device)
    camera = perspective_camera(eye=(0, 0.8, -3.0), target=(0, -0.1, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_opacity_hier_scene(*, device):
    """Opacity plus the two spheres of the ``mid_size`` scene (40 x 20 and
    32 x 16, 2,480 triangles) carrying the cutout material, left and right
    of the box: 2,498 triangles, over the dense megakernel's 1,024, so the
    frame takes the BVH branch with textures, cutouts and the shadow
    march."""
    extra = [(make_sphere(radius=0.6, slices=40, stacks=20), 1,
              _trs((-1.6, 0.6, -0.5))),
             (make_sphere(radius=0.5, slices=32, stacks=16), 1,
              _trs((1.5, 0.5, 0.5)))]
    return create_opacity_scene(extra_instances=extra, device=device)


def sun_environment_map(height: int = 32, width: int = 64) -> np.ndarray:
    """A latlong map [height, width, 3] that is not uniform: a seeded
    gradient (brighter towards one side and the top, tinted per channel)
    with one bright patch off both axes. A flipped u or v, a wrong pdf cell
    or a pool that is not weighted by its pdf changes the frame."""
    rng = np.random.default_rng(11)
    v = (np.arange(height, dtype=F32)[:, None] + 0.5) / height
    u = (np.arange(width, dtype=F32)[None, :] + 0.5) / width
    base = 0.15 + 0.5 * (1.0 - v) + 0.25 * u
    env = base[..., None] * np.asarray([1.0, 0.9, 0.7], F32)
    env = env * rng.uniform(0.9, 1.1, size=env.shape).astype(F32)
    # The patch: rows 5-8 of 32 (above the horizon of the -y-up mapping),
    # columns 43-47 of 64.
    env[height * 5 // 32:height * 9 // 32,
        width * 43 // 64:width * 48 // 64] = (40.0, 36.0, 28.0)
    return env.astype(F32)


def create_sphere_sun_scene(*, device):
    """The Sphere scene under :func:`sun_environment_map`."""
    return create_sphere_scene(environment_map=sun_environment_map(),
                               device=device)


def create_textured_cornell_scene(*, device):
    """``tests/test_pallas_mesh.py:84-120``: a box over the Utils.cpp
    checkered floor (4 units, 0.5-unit checkers) under one sphere light."""
    floor_mesh, floor_mat, floor_tex = _checkered_floor_parts(
        floor_size=4.0, checker_size=0.5)
    textures = TextureBank.build([floor_tex], device=device)
    floor_mat["tint_roughness_texture"] = 0
    mats = MaterialArray.build([
        floor_mat, dielectric((0.6, 0.3, 0.2), 0.4)], device=device)
    instances = [
        (floor_mesh, 0, _trs((0, -0.5, 0))),
        (make_box(size=0.6), 1, _trs((0, -0.2, 0.3))),
    ]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0.0, 1.4, -0.5),
         "radius": 0.2, "power": (30.0,) * 3}], device=device)
    scene = build_render_scene(instances, mats, lights, textures=textures,
                               device=device)
    camera = perspective_camera(eye=(0, 0.6, -2.2), target=(0, -0.2, 0),
                                fov_radians=PI / 4, aspect=1.0, device=device)
    return scene, camera


def _test_scene(materials, instances, lights, device):
    scene = build_render_scene(
        instances, MaterialArray.build(materials, device=device),
        LightArray.build(lights, device=device), device=device)
    camera = perspective_camera(eye=(0, 0.8, -2.6), target=(0, -0.1, 0),
                                fov_radians=PI / 4, aspect=1.0, device=device)
    return scene, camera


def create_coated_scene(*, device):
    """Coat layers: a plain floor, a coated dielectric box and a coated
    metal sphere under one sphere light."""
    materials = [
        dielectric((0.6, 0.6, 0.6), 0.9),
        dielectric((0.2, 0.4, 0.8), 0.1, coat=1.0, coat_roughness=0.0),
        metal((0.95, 0.64, 0.54), 0.5, coat=0.7, coat_roughness=0.3),
    ]
    instances = [
        (make_plane(size=8.0), 0, _trs((0, -0.5, 0))),
        (make_box(size=0.7), 1, _trs((-0.6, -0.15, 0.3))),
        (make_sphere(radius=0.4, slices=12, stacks=8), 2,
         _trs((0.7, -0.1, 0.0))),
    ]
    lights = [{"kind": LIGHT_SPHERE, "position": (1.5, 3.0, -2.0),
               "radius": 0.4, "power": (120.0,) * 3}]
    return _test_scene(materials, instances, lights, device)


def create_spot_light_scene(*, device):
    """A box on a floor under one disk spot light (cone-or-disk NEE, disk
    hits with MIS)."""
    down = np.asarray([0.2, -1.0, 0.3], F32)
    down /= np.linalg.norm(down)
    materials = [dielectric((0.7, 0.7, 0.7), 0.8),
                 dielectric((0.7, 0.2, 0.2), 0.3)]
    instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                 (make_box(size=0.6), 1, _trs((0, -0.2, 0.2)))]
    lights = [{"kind": LIGHT_SPOT, "position": (0.5, 2.5, -0.5),
               "radius": 0.3, "direction": tuple(down), "cos_angle": 0.8,
               "power": (120.0,) * 3}]
    return _test_scene(materials, instances, lights, device)


def create_diffuse_scene(*, device):
    """A Default floor and a Diffuse-model (EON only) box side by side."""
    materials = [dielectric((0.7, 0.7, 0.7), 0.8),
                 dict(tint=(0.2, 0.6, 0.3), roughness=0.6, shading_model=1)]
    instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                 (make_box(size=0.6), 1, _trs((0, -0.2, 0.2)))]
    lights = [{"kind": LIGHT_SPHERE, "position": (1.0, 3.0, -1.5),
               "radius": 0.4, "power": (100.0,) * 3}]
    return _test_scene(materials, instances, lights, device)


def create_emissive_scene(*, device):
    """A box on a floor under an emissive panel facing down, beside a
    small sphere light (surface emission on camera and bounce rays)."""
    materials = [dielectric((0.7, 0.7, 0.7), 0.8),
                 dielectric((0.3, 0.5, 0.7), 0.4),
                 dict(tint=(0.1, 0.1, 0.1), roughness=1.0,
                      emission=(4.0, 3.5, 3.0))]
    instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                 (make_box(size=0.6), 1, _trs((0, -0.2, 0.2))),
                 (make_plane(size=0.8), 2, _trs((0, 1.0, 0.2), (0, 0, 1), PI))]
    lights = [{"kind": LIGHT_SPHERE, "position": (1.0, 2.0, -1.5),
               "radius": 0.1, "power": (20.0,) * 3}]
    return _test_scene(materials, instances, lights, device)


def create_directional_scene(*, device):
    """A box and a glossy metal sphere on a floor under a directional light
    and a small sphere light (RIS over mixed light kinds, the delta-light
    clamp, shadow rays of unbounded length)."""
    ldir = -np.asarray([1.0, 2.0, -1.0], F32)
    ldir /= np.linalg.norm(ldir)
    materials = [dielectric((0.7, 0.7, 0.7), 0.8),
                 dielectric((0.7, 0.5, 0.2), 0.3),
                 metal((0.9, 0.9, 0.9), 0.15)]
    instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                 (make_box(size=0.6), 1, _trs((-0.4, -0.2, 0.2))),
                 (make_sphere(radius=0.3, slices=12, stacks=8), 2,
                  _trs((0.5, -0.2, 0.0)))]
    lights = [{"kind": LIGHT_SPHERE, "position": (1.0, 2.0, -1.5),
               "radius": 0.2, "power": (40.0,) * 3},
              {"kind": LIGHT_DIRECTIONAL, "direction": tuple(ldir),
               "radiance": (3.0, 2.9, 2.5)}]
    return _test_scene(materials, instances, lights, device)


TORUS_GRID_EYE = (0.0, 8.0, -30.0)


def torus_grid_mesh(grid: int = 8, major_segments: int = 96,
                    minor_segments: int = 48, count=None):
    """``grid`` × ``grid`` tori 3 units apart, each lifted by a seeded
    uniform(-1, 1): the transforms and seed of
    ``bench.py::bench_torus_grid``. The defaults give 589,824 triangles;
    ``count`` keeps the first that many tori only."""
    parts = []
    rng = np.random.default_rng(0)
    for i in range(grid):
        for j in range(grid):
            if count is not None and len(parts) >= count:
                break
            m = make_torus(major_segments=major_segments,
                           minor_segments=minor_segments)
            matrix = np.asarray([[1, 0, 0, i * 3 - 12],
                                 [0, 1, 0, rng.uniform(-1, 1)],
                                 [0, 0, 1, j * 3 - 12]], F32)
            parts.append(transform_mesh(m, matrix))
    return combine_meshes(parts)


def create_torus_grid_scene(aspect=1.0, grid: int = 8,
                            major_segments: int = 96,
                            minor_segments: int = 48, count=None, *, device):
    """The torus grid under one sphere light above its centre, one Default
    material, seen from the bench's eye looking at the grid's centre.
    ``count`` keeps the first that many tori; light and camera stay."""
    mesh = torus_grid_mesh(grid, major_segments, minor_segments, count)
    centre = (3.0 * (grid - 1) / 2 - 12.0, 0.0, 3.0 * (grid - 1) / 2 - 12.0)
    mats = MaterialArray.build([dielectric((0.7, 0.6, 0.5), 0.6)],
                               device=device)
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (centre[0], 14.0, centre[2]),
         "radius": 1.5, "power": (6000.0,) * 3}], device=device)
    scene = build_render_scene([(mesh, 0)], mats, lights, device=device)
    camera = perspective_camera(eye=TORUS_GRID_EYE, target=centre,
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


def create_torus_grid_28_scene(*, device):
    """The first 28 tori of the grid: 258,048 triangles, just under the
    megakernel's cap."""
    return create_torus_grid_scene(count=28, device=device)


def create_hier_bridge_scene(slices: int = 128, stacks: int = 80,
                             extra_tori: int = 4, second_sphere=None,
                             environment_map=None, *, device):
    """``bench.py::bench_hier_bridge``'s scenes: a floor, a metal and a
    blue sphere of ``slices`` × ``stacks``, a box and ``extra_tori`` tori
    under one sphere light. (40, 20, 0), (64, 40, 2) and (128, 80, 4) give
    3,054, 14,606 and 49,678 triangles. ``second_sphere`` = (slices,
    stacks) tessellates the blue sphere on its own; an ``environment_map``
    lights the scene too, through a pool of 8,192 samples."""
    second = second_sphere or (slices, stacks)
    materials = [dielectric((0.7, 0.7, 0.7), 0.6),
                 metal((0.95, 0.64, 0.54), 0.3),
                 dielectric((0.2, 0.4, 0.8), 0.2)]
    instances = [
        (make_plane(size=4.0), 0, _trs((0, -0.5, 0))),
        (make_sphere(slices=slices, stacks=stacks), 1,
         _trs((-0.5, 0.0, 0.2))),
        (make_sphere(slices=second[0], stacks=second[1]), 2,
         _trs((0.6, -0.1, -0.2))),
        (make_box(size=0.5), 0, _trs((0.0, -0.3, -0.8)))]
    for i in range(extra_tori):
        instances.append((make_torus(0.35, 0.12, 48, 24), 1,
                          _trs((-1.2 + 0.8 * i, 0.3, -0.6))))
    lights = [{"kind": LIGHT_SPHERE, "position": (0.0, 1.6, 0.5),
               "radius": 0.2, "power": (40.0,) * 3}]
    scene = build_render_scene(
        instances, MaterialArray.build(materials, device=device),
        LightArray.build(lights, device=device),
        environment_map=environment_map,
        presample_environment=8192 if environment_map is not None else 0,
        device=device)
    camera = perspective_camera(eye=(0.0, 0.6, 2.4), target=(0.0, -0.1, 0.0),
                                device=device)
    return scene, camera


def create_mid_size_scene(*, device):
    """``tests/test_pallas_mesh.py::_mid_size_scene``: the bridge scene with
    a 40 × 20 and a 32 × 16 sphere and no torus, 2,494 triangles."""
    return create_hier_bridge_scene(40, 20, 0, second_sphere=(32, 16),
                                    device=device)


HIER_BRIDGE_SIZES = {"hier_bridge_3k": ((40, 20, 0), 3054),
                     "hier_bridge_15k": ((64, 40, 2), 14606),
                     "hier_bridge_50k": ((128, 80, 4), 49678)}


def _hier_bridge(name, environment_map=None):
    def build(*, device):
        args, n_tris = HIER_BRIDGE_SIZES[name]
        env = None if environment_map is None else environment_map()
        scene, camera = create_hier_bridge_scene(
            *args, environment_map=env, device=device)
        assert int(scene.tri_verts.shape[0]) == n_tris, scene.tri_verts.shape
        return scene, camera
    return build


TEST_SCENES = {"coated": create_coated_scene,
               "spot": create_spot_light_scene,
               "diffuse": create_diffuse_scene,
               "emissive": create_emissive_scene,
               "directional": create_directional_scene,
               "torus_grid": create_torus_grid_scene,
               "mid_size": create_mid_size_scene,
               **{name: _hier_bridge(name) for name in HIER_BRIDGE_SIZES},
               "torus_grid_28": create_torus_grid_28_scene,
               "textured_cornell": create_textured_cornell_scene,
               "sphere_sun": create_sphere_sun_scene,
               "hier_bridge_15k_env": _hier_bridge("hier_bridge_15k",
                                                   sun_environment_map),
               "opacity_hier": create_opacity_hier_scene}

SCENES = {"CornellBox": create_cornell_box,
          "MaterialScene": create_material_scene,
          "MaterialSceneLegacy": create_legacy_material_scene,
          "Veach": create_veach_scene,
          "Sphere": create_sphere_scene,
          "SphereLight": create_sphere_light_scene,
          "Glass": create_glass_scene,
          "Opacity": create_opacity_scene,
          "Test": create_test_scene}
