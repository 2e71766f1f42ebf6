"""SimpleViewer: the offline CLI renderer.

Port of ``bifrost3d_tpu/apps/simple_viewer.py`` (``build_scene_from_file``,
``main``): load one of the nine built-in scenes (CornellBox, MaterialScene,
MaterialSceneLegacy, Veach, Sphere, SphereLight, Glass, Opacity, Test) or
an ``.obj`` / ``.gltf`` / ``.glb`` file, render it progressively through
``render_sample_fast`` (on a card the mesh megakernel where the scene is
eligible, else the pooled wavefront), apply the camera-effects chain and
write a PNG or an EXR; or, with ``--aov``, write one of the six AOVs of
``integrator/aov.render_aovs`` instead.

As the JAX viewer:
- ``--environment-map`` (a latlong PNG, EXR, or through PIL JPG / TGA)
  replaces ``environment`` on a built-in scene and leaves its presampled
  pool as it was, so that on Sphere, Glass and Test next-event estimation
  still draws the old map's pool while escaped rays see the new map; on a
  file it goes into ``build_render_scene`` (no pool);
- a file's camera looks at the scene's box from its diagonal, at aspect
  1.0 whatever the window's;
- the render settings are a plain ``RenderSettings`` with the bounce
  count, so shadow rays are binary any-hit queries on every scene;
- an AOV is written as its values in [0, 1], not sRGB-encoded;
- ``--renderer preview`` renders one frame of ``preview.render_preview``
  (primary and shadow traces, SSAO), ``--renderer denoised`` ``-n``
  frames of ``integrator/backend.DenoisedBackend`` (the running mean
  filtered by the à-trous denoiser on its cadence), both without film
  grain; ``--path-regularization`` sets the path tracer's
  ``path_regularization_scale``;
- ``--checkpoint-dir`` accumulates through ``SimpleBackend``, resumes from
  the directory's latest ``ckpt_<n>.npz`` when its scene is ``--scene``
  and n < ``-n`` (printing "resumed at accumulation n"), and writes a
  checkpoint every ``--checkpoint-every`` accumulations and at the last.

Usage::

    python -m bifrost3d_tpu_torch.apps.simple_viewer --scene model.glb \\
        --environment-map sky.exr -n 64 -o build/model.png
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

_TONEMAPPERS = ("linear", "filmic", "agx", "khronos")
AOVS = ("depth", "albedo", "tint", "roughness", "shading_normal",
        "primitive_id")


def viewer_camera(position, target, width: int, height: int, device):
    """The camera of ``--camera-position`` / ``--camera-target`` ("x,y,z"
    strings, None for the default eye (0, 0, -2) or target (0, 0, 0)): a
    45-degree perspective camera at the window's aspect, as the JAX
    viewer's."""
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    eye = tuple(float(v) for v in (position or "0,0,-2").split(","))
    target = tuple(float(v) for v in (target or "0,0,0").split(","))
    return perspective_camera(eye=eye, target=target,
                              fov_radians=math.pi / 4, aspect=width / height,
                              device=device)


def build_scene_from_file(path, environment_map, environment_tint, *,
                          device):
    """A scene file (.obj, .gltf, .glb) → (RenderScene, PinholeCamera) on
    ``device``: its meshes, materials and textures, ``environment_map`` (a
    latlong radiance map, or None) and the background tint, and a camera on
    the diagonal of the scene's box at 2.2 times its radius."""
    from bifrost3d_tpu_torch.geometry.mesh import mesh_aabb
    from bifrost3d_tpu_torch.io import load_gltf, load_obj
    from bifrost3d_tpu_torch.io.texture import TextureBank
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    from bifrost3d_tpu_torch.scene.materials import MaterialArray
    from bifrost3d_tpu_torch.scene.render_scene import build_render_scene

    texture_dicts = []
    if path.lower().endswith((".gltf", ".glb")):
        meshes, material_dicts, texture_dicts = load_gltf(path)
    elif path.lower().endswith(".obj"):
        meshes, material_dicts = load_obj(path)
    else:
        raise ValueError(f"unsupported scene file {path}")
    mats = MaterialArray.build(material_dicts, device=device)
    instances = [(m, idx, None) for m, idx, _name in meshes]
    scene = build_render_scene(
        instances, mats, environment_map=environment_map,
        environment_tint=environment_tint,
        textures=TextureBank.build(texture_dicts, device=device),
        device=device)

    # Frame the scene: camera on the diagonal at 2.2x the bounding radius.
    boxes = [mesh_aabb(m) for m, _, _ in meshes]
    lo = np.asarray([b[0] for b in boxes]).min(0)
    hi = np.asarray([b[1] for b in boxes]).max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
    eye = center + np.asarray([0.7, 0.4, -1.0]) * 2.2 * radius
    camera = perspective_camera(eye=tuple(eye), target=tuple(center),
                                fov_radians=np.pi / 4, aspect=1.0,
                                device=device)
    return scene, camera


def viewer_scene(name, environment_map, environment_tint, width: int,
                 height: int, *, device):
    """The scene and camera ``main`` renders: a built-in scene at the
    window's aspect (the reference's CameraViewportHandler, main.cpp:350),
    ``environment_map`` replacing its environment (its presampled pool
    kept, as the JAX viewer keeps it) and the tint its background; or a
    scene file through :func:`build_scene_from_file`."""
    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.lights.environment import build_environment_light
    if name not in SCENES:
        return build_scene_from_file(name, environment_map, environment_tint,
                                     device=device)
    scene, camera = SCENES[name](aspect=width / height, device=device)
    if environment_map is not None:
        scene = scene._replace(environment=build_environment_light(
            environment_map, device=device))
    scene = scene._replace(environment_tint=torch.tensor(
        environment_tint, dtype=torch.float32, device=device))
    return scene, camera


def aov_image(aovs: dict, name: str) -> np.ndarray:
    """One AOV as the [h, w, 3] image the viewer writes: a scalar AOV in
    all three channels, the shading normal mapped from [-1, 1] to [0, 1],
    clipped to [0, 1]."""
    img = aovs[name].detach().cpu().numpy()
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if name == "shading_normal":
        img = img * 0.5 + 0.5
    return np.clip(img, 0, 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="PyTorch/CUDA path tracer")
    parser.add_argument("--scene", "-s", default="CornellBox",
                        help="built-in scene name or .obj/.gltf/.glb path")
    parser.add_argument("--environment-map", "-e", default=None,
                        help="latlong environment image (png/exr; jpg/tga "
                             "where PIL is installed)")
    parser.add_argument("--environment-tint", default="0.68,0.92,1.0",
                        help="R,G,B background tint when no map is set "
                             "(SimpleViewer default, main.cpp:58)")
    parser.add_argument("--window-size", default="512x512")
    parser.add_argument("--camera-position", default=None, help="x,y,z")
    parser.add_argument("--camera-target", default=None, help="x,y,z")
    parser.add_argument("--accumulations", "-n", type=int, default=64)
    parser.add_argument("--max-bounces", type=int, default=4)
    parser.add_argument("--output", "-o", default="render.png",
                        help=".png (sRGB) or .exr (linear)")
    parser.add_argument("--aov", default=None, choices=[None, *AOVS],
                        help="render an AOV instead of the beauty pass")
    parser.add_argument("--tonemapper", default="filmic", choices=_TONEMAPPERS)
    parser.add_argument("--path-regularization", type=float, default=0.0,
                        help="path regularization scale (0 = off)")
    parser.add_argument("--high-precision", action="store_true",
                        help="Kahan-compensated accumulation")
    parser.add_argument("--renderer", default="pathtracer",
                        choices=["pathtracer", "preview", "denoised"],
                        help="path tracer, rasterizer-style preview (the "
                             "reference's 'P' toggle), or denoised backend")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="resume progressive accumulation from the "
                             "latest checkpoint here and save new ones")
    parser.add_argument("--checkpoint-every", type=int, default=64,
                        help="checkpoint interval in accumulations")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)

    from bifrost3d_tpu_torch.integrator.aov import render_aovs
    from bifrost3d_tpu_torch.integrator.path_tracer import (
        RenderSettings,
        render_progressive,
    )
    from bifrost3d_tpu_torch.io.image import load_image, save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    device = torch.device(args.device)
    width, height = (int(v) for v in args.window_size.split("x"))
    env = load_image(args.environment_map) if args.environment_map else None
    tint = tuple(float(v) for v in args.environment_tint.split(","))

    scene, camera = viewer_scene(args.scene, env, tint, width, height,
                                 device=device)
    if args.camera_position or args.camera_target:
        camera = viewer_camera(args.camera_position, args.camera_target,
                               width, height, device)

    post = CameraEffectsSettings.preset()._replace(
        tonemapping_mode=_TONEMAPPERS.index(args.tonemapper), film_grain=0.0)
    t0 = time.time()
    if args.renderer == "preview" and not args.aov:
        from bifrost3d_tpu_torch.preview import render_preview
        hdr = render_preview(scene, camera, width, height)
        save_image(args.output, process(hdr, post))
        print(f"rendered {args.scene} preview {width}x{height} on {device} "
              f"in {time.time() - t0:.1f}s -> {args.output}")
        return
    if args.renderer == "denoised" and not args.aov:
        from bifrost3d_tpu_torch.integrator.backend import DenoisedBackend
        backend = DenoisedBackend(
            scene, camera, width, height,
            RenderSettings(max_bounce_count=args.max_bounces))
        for _ in range(args.accumulations):
            hdr = backend.render()
        save_image(args.output, process(hdr, post))
        print(f"rendered {args.scene} denoised {width}x{height} "
              f"n={args.accumulations} on {device} in "
              f"{time.time() - t0:.1f}s -> {args.output}")
        return
    if args.aov:
        aovs = render_aovs(scene, camera, width, height)
        save_image(args.output, aov_image(aovs, args.aov), from_linear=False)
    else:
        settings = RenderSettings(
            max_bounce_count=args.max_bounces,
            path_regularization_scale=args.path_regularization)
        if args.checkpoint_dir:
            hdr = _render_with_checkpoints(args, scene, camera, width,
                                           height, settings)
        else:
            hdr = render_progressive(scene, camera, width, height,
                                     args.accumulations, settings,
                                     high_precision=args.high_precision)
        save_image(args.output, process(hdr, post))
    print(f"rendered {args.scene} {width}x{height} n={args.accumulations} "
          f"on {device} in {time.time() - t0:.1f}s -> {args.output}")


def _render_with_checkpoints(args, scene, camera, width, height, settings):
    """Durable progressive accumulation: resume from the latest checkpoint
    of ``--checkpoint-dir`` (its scene ``--scene``, its step below ``-n``),
    continue, and save every ``--checkpoint-every`` accumulations and at
    the last → the running mean."""
    import os
    from bifrost3d_tpu_torch.integrator.backend import SimpleBackend
    from bifrost3d_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    backend = SimpleBackend(scene, camera, width, height, settings)
    resume = latest_checkpoint(args.checkpoint_dir)
    if resume is not None:
        state, step, meta = load_checkpoint(resume,
                                            like={"buffer": backend.buffer})
        if meta.get("scene") == args.scene and step < args.accumulations:
            backend.buffer = state["buffer"]
            backend.accumulations = step
            print(f"resumed at accumulation {step} from {resume}")
    hdr = backend.buffer
    while backend.accumulations < args.accumulations:
        hdr = backend.render()
        n = backend.accumulations
        if n % args.checkpoint_every == 0 or n == args.accumulations:
            save_checkpoint(
                os.path.join(args.checkpoint_dir, f"ckpt_{n}.npz"),
                {"buffer": backend.buffer}, step=n,
                metadata={"scene": args.scene})
    return hdr


if __name__ == "__main__":
    main()
