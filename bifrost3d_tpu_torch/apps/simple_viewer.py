"""SimpleViewer: the offline CLI renderer, path-tracer branch.

Port of ``bifrost3d_tpu/apps/simple_viewer.py::main`` for the nine
built-in scenes (CornellBox, MaterialScene, MaterialSceneLegacy, Veach,
Sphere, SphereLight, Glass, Opacity, Test): render
progressively through ``render_sample_fast`` (on a card the mesh megakernel,
one launch per frame), apply the camera-effects chain and write a PNG.
``--camera-position`` / ``--camera-target`` replace the scene's camera as
in the JAX viewer. The
render settings are the reference viewer's: a plain ``RenderSettings`` with
the bounce count, so shadow rays are binary any-hit queries on every scene
(Opacity too; ``settings_for_scene`` is what turns the coverage-aware march
on for a library caller). ``--environment-tint`` sets the background of a
scene without a map; ``--environment-map`` needs an image reader, which the
port does not have yet.

Usage::

    python -m bifrost3d_tpu_torch.apps.simple_viewer --scene CornellBox \\
        -n 64 -o build/cornell.png
"""

from __future__ import annotations

import argparse
import math
import time

import torch

_TONEMAPPERS = ("linear", "filmic", "agx", "khronos")


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


def main(argv=None):
    parser = argparse.ArgumentParser(description="PyTorch/CUDA path tracer")
    parser.add_argument("--scene", "-s", default="CornellBox",
                        help="built-in scene name")
    parser.add_argument("--environment-map", "-e", default=None,
                        help="latlong environment image (not ported: the "
                             "port has no image reader yet)")
    parser.add_argument("--environment-tint", default="0.68,0.92,1.0",
                        help="R,G,B background tint (SimpleViewer default, "
                             "main.cpp:58)")
    parser.add_argument("--window-size", default="512x512")
    parser.add_argument("--camera-position", default=None, help="x,y,z")
    parser.add_argument("--camera-target", default=None, help="x,y,z")
    parser.add_argument("--accumulations", "-n", type=int, default=64)
    parser.add_argument("--max-bounces", type=int, default=4)
    parser.add_argument("--output", "-o", default="render.png")
    parser.add_argument("--tonemapper", default="filmic", choices=_TONEMAPPERS)
    parser.add_argument("--high-precision", action="store_true",
                        help="Kahan-compensated accumulation")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)

    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.integrator.path_tracer import (
        RenderSettings,
        render_progressive,
    )
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    if args.environment_map is not None:
        raise NotImplementedError(
            "--environment-map: the port has no image reader yet (png, jpg, "
            "hdr, exr); the Sphere scene carries its own map")
    if args.scene not in SCENES:
        raise NotImplementedError(
            f"scene {args.scene!r}: the port has no .obj / .gltf loader "
            f"yet; built-in scenes: {sorted(SCENES)}")
    device = torch.device(args.device)
    width, height = (int(v) for v in args.window_size.split("x"))
    tint = tuple(float(v) for v in args.environment_tint.split(","))

    scene, camera = SCENES[args.scene](aspect=width / height, device=device)
    scene = scene._replace(environment_tint=torch.tensor(
        tint, dtype=torch.float32, device=device))
    if args.camera_position or args.camera_target:
        camera = viewer_camera(args.camera_position, args.camera_target,
                               width, height, device)

    t0 = time.time()
    settings = RenderSettings(max_bounce_count=args.max_bounces)
    hdr = render_progressive(scene, camera, width, height, args.accumulations,
                             settings, high_precision=args.high_precision)
    post = CameraEffectsSettings.preset()._replace(
        tonemapping_mode=_TONEMAPPERS.index(args.tonemapper), film_grain=0.0)
    save_image(args.output, process(hdr, post))
    print(f"rendered {args.scene} {width}x{height} n={args.accumulations} "
          f"on {device} in {time.time() - t0:.1f}s -> {args.output}")


if __name__ == "__main__":
    main()
