"""The mutable scene datamodel: UID-handled managers with change tracking.

Port of ``bifrost3d_tpu/scene/datamodel.py`` (the nine managers,
``SceneData``, ``_transform_to_matrix``, ``SceneSync``), the counterpart
of the reference's L2 (``Bifrost/Assets`` + ``Bifrost/Scene``, SURVEY.md
§2.3): SceneNodes (hierarchy and global transforms), SceneRoots
(environment), Cameras (per-camera renderer selection, z-order, screenshot
requests), LightSources, Meshes, Images, Textures, Materials and
MeshModels, each a manager with create/destroy, typed UIDs and a per-tick
ChangeSet.

The datamodel is host state: transforms are CPU tensors, meshes numpy,
material parameters and lights plain dicts. Only :class:`SceneSync`, the
``handle_updates`` analogue, puts data on a device: it builds the port's
``RenderScene`` on the device it is given and, when managers report
changes, rebuilds only what they touched, reusing every other tensor by
identity (so the megakernel's per-identity pack caches keep hitting).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from bifrost3d_tpu_torch.core.changeset import ChangeSet
from bifrost3d_tpu_torch.core.uid import UID, TypedUIDGenerator
from bifrost3d_tpu_torch.geometry.mesh import TriangleMesh
from bifrost3d_tpu_torch.io.pixel_image import (
    INTENSITY_FLOAT,
    RGB_FLOAT,
    RGBA_FLOAT,
    PixelImage,
)
from bifrost3d_tpu_torch.io.texture import TextureBank
from bifrost3d_tpu_torch.lights.environment import build_environment_light
from bifrost3d_tpu_torch.lights.types import (
    LIGHT_DIRECTIONAL,
    LIGHT_SPHERE,
    LIGHT_SPOT,
    LightArray,
)
from bifrost3d_tpu_torch.math.quaternion import quat_rotate, quat_to_matrix
from bifrost3d_tpu_torch.math.transform import Transform, transform_identity
from bifrost3d_tpu_torch.scene.camera import (
    PinholeCamera,
    perspective_projection,
)
from bifrost3d_tpu_torch.scene.materials import MaterialArray
from bifrost3d_tpu_torch.scene.render_scene import (
    RenderScene,
    build_render_scene,
    refit_render_scene,
)


class _Manager:
    """Shared manager pattern: UID slots + ChangeSet."""

    def __init__(self):
        self._ids = TypedUIDGenerator()
        self._data: Dict[int, object] = {}
        self.changes = ChangeSet()

    def _create(self, payload) -> UID:
        uid = self._ids.generate()
        self._data[int(uid)] = payload
        self.changes.add_change(uid, ChangeSet.CREATED)
        return uid

    def destroy(self, uid: UID) -> bool:
        if not self._ids.has(uid):
            return False
        self._ids.erase(uid)
        del self._data[int(uid)]
        self.changes.add_change(uid, ChangeSet.DESTROYED)
        return True

    def has(self, uid: UID) -> bool:
        return self._ids.has(uid)

    def __iter__(self):
        return iter(self._ids)

    def __len__(self):
        return self._ids.count

    def _get(self, uid: UID):
        return self._data[int(uid)]

    def _touch(self, uid: UID):
        self.changes.add_change(uid, ChangeSet.UPDATED)

    def reset_change_notifications(self):
        self.changes.reset_change_notifications()


# -- Scene graph -----------------------------------------------------------------

@dataclass
class _Node:
    name: str
    global_transform: Transform
    parent: Optional[UID] = None
    children: List[UID] = field(default_factory=list)


class SceneNodes(_Manager):
    """Scene graph storing GLOBAL transforms (local derived on demand), the
    reference's storage choice (Scene/SceneNode.h:39-112)."""

    def create(self, name: str, transform: Transform = None) -> UID:
        return self._create(_Node(name, transform or transform_identity()))

    def get_name(self, uid: UID) -> str:
        return self._get(uid).name

    def get_global_transform(self, uid: UID) -> Transform:
        return self._get(uid).global_transform

    def set_global_transform(self, uid: UID, t: Transform) -> None:
        # Children keep their global transforms, as in the reference.
        self._get(uid).global_transform = t
        self._touch(uid)

    def set_parent(self, uid: UID, parent: Optional[UID]) -> None:
        node = self._get(uid)
        if node.parent is not None and self.has(node.parent):
            self._get(node.parent).children.remove(uid)
        node.parent = parent
        if parent is not None:
            self._get(parent).children.append(uid)
        self._touch(uid)

    def get_parent(self, uid: UID) -> Optional[UID]:
        return self._get(uid).parent

    def get_children(self, uid: UID) -> List[UID]:
        return list(self._get(uid).children)

    def apply_recursively(self, uid: UID, fn) -> None:
        """Depth-first, parent before children (SceneNode.h:174-210)."""
        stack = [uid]
        while stack:
            n = stack.pop()
            fn(n)
            stack.extend(reversed(self.get_children(n)))

    def apply_to_children_recursively(self, uid: UID, fn) -> None:
        for child in self.get_children(uid):
            self.apply_recursively(child, fn)


@dataclass
class _SceneRoot:
    name: str
    root_node: UID
    environment_tint: tuple = (0.0, 0.0, 0.0)
    environment_map: Optional[np.ndarray] = None


class SceneRoots(_Manager):
    ENVIRONMENT_TINT_CHANGED = 8
    ENVIRONMENT_MAP_CHANGED = 16

    def create(self, name: str, root_node: UID,
               environment_tint=(0, 0, 0), environment_map=None) -> UID:
        return self._create(_SceneRoot(name, root_node,
                                       environment_tint, environment_map))

    def get_root_node(self, uid: UID) -> UID:
        return self._get(uid).root_node

    def get_environment_tint(self, uid: UID):
        return self._get(uid).environment_tint

    def set_environment_tint(self, uid: UID, tint) -> None:
        self._get(uid).environment_tint = tuple(tint)
        self.changes.add_change(uid, self.ENVIRONMENT_TINT_CHANGED)

    def get_environment_map(self, uid: UID):
        return self._get(uid).environment_map

    def set_environment_map(self, uid: UID, image) -> None:
        self._get(uid).environment_map = image
        self.changes.add_change(uid, self.ENVIRONMENT_MAP_CHANGED)


# -- Assets ----------------------------------------------------------------------

class Meshes(_Manager):
    def create(self, name: str, mesh: TriangleMesh) -> UID:
        return self._create((name, mesh))

    def get_mesh(self, uid: UID) -> TriangleMesh:
        return self._get(uid)[1]

    def get_name(self, uid: UID) -> str:
        return self._get(uid)[0]

    def set_mesh(self, uid: UID, mesh: TriangleMesh) -> None:
        self._data[int(uid)] = (self._get(uid)[0], mesh)
        self._touch(uid)


class Materials(_Manager):
    def create(self, name: str, **params) -> UID:
        return self._create((name, dict(params)))

    def get_params(self, uid: UID) -> dict:
        return dict(self._get(uid)[1])

    def set_param(self, uid: UID, key: str, value) -> None:
        self._get(uid)[1][key] = value
        self._touch(uid)

    # Convenience setters mirroring the reference's API surface.
    def set_tint(self, uid: UID, tint) -> None:
        self.set_param(uid, "tint", tuple(tint))

    def set_roughness(self, uid: UID, r: float) -> None:
        self.set_param(uid, "roughness", float(r))

    def set_metallic(self, uid: UID, m: float) -> None:
        self.set_param(uid, "metallic", float(m))

    def set_coverage(self, uid: UID, c: float) -> None:
        self.set_param(uid, "coverage", float(c))

    def set_emission(self, uid: UID, e) -> None:
        self.set_param(uid, "emission", tuple(e))


class Images(_Manager):
    """Pixel-image assets (Assets/Image.h manager): PixelImage payloads or
    raw float arrays (wrapped as INTENSITY_FLOAT, RGB_FLOAT or
    RGBA_FLOAT)."""

    def create(self, name: str, image) -> UID:
        if not isinstance(image, PixelImage):
            arr = np.asarray(image, np.float32)
            if arr.ndim == 2:
                arr = arr[..., None]
            fmt = {1: INTENSITY_FLOAT, 3: RGB_FLOAT,
                   4: RGBA_FLOAT}[arr.shape[-1]]
            image = PixelImage(fmt, (arr.shape[1], arr.shape[0]), data=arr)
        return self._create((name, image))

    def get_image(self, uid: UID):
        return self._get(uid)[1]

    def get_name(self, uid: UID) -> str:
        return self._get(uid)[0]

    def set_image(self, uid: UID, image) -> None:
        self._data[int(uid)] = (self._get(uid)[0], image)
        self._touch(uid)


class Textures(_Manager):
    """Sampler state over an Image (Assets/Texture.h): filter + wrap."""

    def create(self, image: UID, magnification_filter: int = 1,
               wrap_u: int = 1, wrap_v: int = 1) -> UID:
        return self._create(dict(image=image,
                                 filter=int(magnification_filter),
                                 wrap_u=int(wrap_u), wrap_v=int(wrap_v)))

    def get_sampler(self, uid: UID) -> dict:
        return dict(self._get(uid))

    def get_image_uid(self, uid: UID) -> UID:
        return self._get(uid)["image"]


class MeshModels(_Manager):
    """(scene node, mesh, material) binding (Assets/MeshModel.h)."""

    def create(self, node: UID, mesh: UID, material: UID) -> UID:
        return self._create((node, mesh, material))

    def get_binding(self, uid: UID):
        return self._get(uid)


class LightSources(_Manager):
    """Tagged sphere/spot/directional lights bound to scene nodes
    (Scene/LightSource.h:33-120)."""

    def create_sphere_light(self, node: UID, power, radius: float) -> UID:
        return self._create(dict(kind=LIGHT_SPHERE, node=node,
                                 power=tuple(power), radius=float(radius)))

    def create_spot_light(self, node: UID, power, radius: float,
                          cos_angle: float) -> UID:
        return self._create(dict(kind=LIGHT_SPOT, node=node,
                                 power=tuple(power), radius=float(radius),
                                 cos_angle=float(cos_angle)))

    def create_directional_light(self, node: UID, radiance) -> UID:
        return self._create(dict(kind=LIGHT_DIRECTIONAL, node=node,
                                 radiance=tuple(radiance)))

    def get_light(self, uid: UID) -> dict:
        return dict(self._get(uid))

    def is_delta_light(self, uid: UID) -> bool:
        d = self._get(uid)
        return d["kind"] == LIGHT_DIRECTIONAL or d.get("radius", 0) == 0

    def set_power(self, uid: UID, power) -> None:
        self._get(uid)["power"] = tuple(power)
        self._touch(uid)


@dataclass
class _Camera:
    name: str
    scene_root: UID
    transform: Transform
    fov_radians: float = np.pi / 4
    aspect: float = 1.0
    near: float = 0.1
    far: float = 1000.0
    z_index: int = 0
    renderer_id: int = 0
    screenshot_request: Optional[dict] = None
    screenshots: List[dict] = field(default_factory=list)


class Cameras(_Manager):
    """Cameras with per-camera renderer selection, z-ordering, and the
    screenshot request → fill → resolve pipeline (Scene/Camera.h:62-192)."""

    def create(self, name: str, scene_root: UID,
               transform: Transform = None, **params) -> UID:
        return self._create(_Camera(name, scene_root,
                                    transform or transform_identity(),
                                    **params))

    def get_transform(self, uid: UID) -> Transform:
        return self._get(uid).transform

    def set_transform(self, uid: UID, t: Transform) -> None:
        self._get(uid).transform = t
        self._touch(uid)

    def set_renderer(self, uid: UID, renderer_id: int) -> None:
        self._get(uid).renderer_id = renderer_id
        self._touch(uid)

    def get_renderer(self, uid: UID) -> int:
        return self._get(uid).renderer_id

    def get_z_index(self, uid: UID) -> int:
        return self._get(uid).z_index

    def get_z_sorted_ids(self) -> List[UID]:
        return sorted(self, key=lambda u: self._get(u).z_index)

    def to_pinhole(self, uid: UID, *, device) -> PinholeCamera:
        """The camera as a ``PinholeCamera`` on ``device``."""
        c = self._get(uid)
        proj, inv = perspective_projection(c.near, c.far, c.fov_radians,
                                           c.aspect, device=device)
        return PinholeCamera(
            transform=Transform(*(f.to(device) for f in c.transform)),
            projection=proj, inverse_projection=inv)

    # Screenshot pipeline (Camera.cpp:190-222): request → renderer fills →
    # resolve into images.
    def request_screenshot(self, uid: UID, content="hdr",
                           minimum_iteration_count: int = 1) -> None:
        self._get(uid).screenshot_request = dict(
            content=content, minimum_iteration_count=minimum_iteration_count)

    def is_screenshot_requested(self, uid: UID) -> bool:
        return self._get(uid).screenshot_request is not None

    def fill_screenshot(self, uid: UID, image, iteration_count: int) -> None:
        """Keep a copy of ``image``: the renderer may write its buffer
        again on a later frame."""
        c = self._get(uid)
        req = c.screenshot_request
        if req is None or iteration_count < req["minimum_iteration_count"]:
            return
        c.screenshots.append(dict(content=req["content"], image=image.clone(),
                                  iterations=iteration_count))
        c.screenshot_request = None

    def resolve_screenshot(self, uid: UID):
        """→ list of filled screenshots, clearing them (Camera resolve)."""
        c = self._get(uid)
        out, c.screenshots = c.screenshots, []
        return out


# -- SceneData and SceneSync: the handle_updates analogue ---------------------------

class SceneData:
    """One bundle of all managers (the reference's static allocate pattern
    made instance-based: no global singletons)."""

    def __init__(self):
        self.nodes = SceneNodes()
        self.roots = SceneRoots()
        self.meshes = Meshes()
        self.images = Images()
        self.textures = Textures()
        self.materials = Materials()
        self.models = MeshModels()
        self.lights = LightSources()
        self.cameras = Cameras()

    def all_managers(self):
        return (self.nodes, self.roots, self.meshes, self.images,
                self.textures, self.materials, self.models, self.lights,
                self.cameras)

    def reset_change_notifications(self):
        """The tick-cleanup callback body (SimpleViewer main.cpp:298-308)."""
        for m in self.all_managers():
            m.reset_change_notifications()

    @property
    def any_changes(self) -> bool:
        return any(m.changes.any_changes for m in self.all_managers())

    @property
    def scene_changes(self) -> bool:
        """Changes that invalidate the device scene: everything but
        cameras (a camera move restarts only that camera's accumulation)."""
        return any(m.changes.any_changes for m in self.all_managers()
                   if m is not self.cameras)


def _transform_to_matrix(t: Transform) -> np.ndarray:
    """A host transform → the [3, 4] float32 matrix ``transform_mesh``
    applies."""
    rot = quat_to_matrix(t.rotation).numpy().astype(np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = rot * float(t.scale)
    m[:, 3] = t.translation.numpy()
    return m


def _updates_only(manager) -> bool:
    return all(manager.changes.get_changes(uid) == ChangeSet.UPDATED
               for uid in manager.changes.get_changed_resources())


class SceneSync:
    """Keeps a ``RenderScene`` on ``device`` in step with the datamodel and
    tracks the progressive accumulation reset (Renderer.cpp:578-1205
    collapsed)."""

    def __init__(self, data: SceneData, *, device):
        self.data = data
        self.device = torch.device(device)
        self._render_scene: Optional[RenderScene] = None
        self.accumulations = 0

    def handle_updates(self) -> RenderScene:
        """The scene as of the datamodel's changes. A tick whose managers
        report none returns the same object. Otherwise the ChangeSet bits
        choose what to rebuild: a materials-only or lights-only update
        replaces that table, a node transform refits the BVH (lights follow
        their nodes), a scene-root edit replaces the environment, anything
        else rebuilds the scene; every tensor not rebuilt is reused by
        identity. Any rebuild restarts accumulation
        (Renderer.cpp:1202-1204); a camera-only change is the compositor's
        to handle."""
        d = self.data
        if self._render_scene is None:
            self._render_scene = self._build()
            self.accumulations = 0
            return self._render_scene
        if not d.scene_changes:
            return self._render_scene

        managers = dict(nodes=d.nodes, roots=d.roots, meshes=d.meshes,
                        images=d.images, textures=d.textures,
                        materials=d.materials, models=d.models,
                        lights=d.lights)
        changed = {k for k, m in managers.items() if m.changes.any_changes}
        scene = self._render_scene
        if changed == {"materials"} and _updates_only(d.materials):
            scene = scene._replace(materials=self._build_materials())
        elif changed == {"lights"} and _updates_only(d.lights):
            scene = scene._replace(lights=self._build_lights())
        elif changed == {"nodes"} and _updates_only(d.nodes):
            scene = refit_render_scene(scene, self._instances())._replace(
                lights=self._build_lights())
        elif changed == {"roots"}:
            # As the JAX package's: the new environment carries no
            # presampled pool, so the megakernel declines the scene.
            env_map, env_tint = self._root_environment()
            env = None
            if env_map is not None:
                env = build_environment_light(env_map, tint=(1.0, 1.0, 1.0),
                                              device=self.device)
            scene = scene._replace(
                environment=env,
                environment_tint=torch.tensor(env_tint, dtype=torch.float32,
                                              device=self.device),
                environment_presampled=None)
        else:
            scene = self._build()
        self._render_scene = scene
        self.accumulations = 0
        return self._render_scene

    def _build_materials(self) -> MaterialArray:
        d = self.data
        tex_index = {int(uid): i for i, uid in enumerate(d.textures)}
        material_params = []
        for uid in d.materials:
            p = d.materials.get_params(uid)
            for key in ("tint_roughness_texture", "metallic_texture",
                        "coverage_texture"):
                if key in p and p[key] is not None and int(p[key]) >= 0:
                    p[key] = tex_index.get(int(p[key]), -1)
                else:
                    p[key] = -1
            material_params.append(p)
        return MaterialArray.build(material_params or [dict()],
                                   device=self.device)

    def _build_lights(self) -> LightArray:
        d = self.data
        light_dicts = []
        for light_id in d.lights:
            li = d.lights.get_light(light_id)
            t = d.nodes.get_global_transform(li.pop("node"))
            li["position"] = tuple(t.translation.numpy())
            if li["kind"] == LIGHT_DIRECTIONAL:
                li["direction"] = tuple(quat_rotate(
                    t.rotation, torch.tensor([0.0, 0.0, 1.0])).numpy())
            light_dicts.append(li)
        return LightArray.build(light_dicts, device=self.device)

    def _instances(self):
        d = self.data
        mat_index = {int(uid): i for i, uid in enumerate(d.materials)}
        instances = []
        for model_id in d.models:
            node, mesh_id, mat_id = d.models.get_binding(model_id)
            instances.append((d.meshes.get_mesh(mesh_id),
                              mat_index.get(int(mat_id), 0),
                              _transform_to_matrix(
                                  d.nodes.get_global_transform(node))))
        return instances

    def _root_environment(self):
        """(map, tint) of the first scene root."""
        for root_id in self.data.roots:
            return (self.data.roots.get_environment_map(root_id),
                    self.data.roots.get_environment_tint(root_id))
        return None, (0.0, 0.0, 0.0)

    def _build(self) -> RenderScene:
        d = self.data
        # Textures: every sampler into one TextureBank; material texture
        # UIDs become bank indices (Renderer.cpp:650-751, collapsed).
        bank_entries = []
        for tex_uid in d.textures:
            s = d.textures.get_sampler(tex_uid)
            img = d.images.get_image(s["image"])
            bank_entries.append(dict(
                image=img.to_float()[0], filter=s["filter"],
                wrap_u=s["wrap_u"], wrap_v=s["wrap_v"]))
        env_map, env_tint = self._root_environment()
        return build_render_scene(
            self._instances(), self._build_materials(), self._build_lights(),
            environment_map=env_map, environment_tint=env_tint,
            textures=TextureBank.build(bank_entries, device=self.device),
            device=self.device)
