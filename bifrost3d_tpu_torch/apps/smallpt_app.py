"""SmallPT app: the standalone progressive sphere tracer.

Port of ``bifrost3d_tpu/apps/smallpt_app.py`` (``render_progressive``,
``main``): progressive accumulation over the 9-sphere Cornell box,
``--volumetric`` switches to the smallvpt homogeneous-medium variant, and
the result is written as a PNG.

On a CUDA card the forward render takes the SmallPT megakernel
(``integrator/pallas_smallpt.py``): a frame is one kernel launch that
renders whole paths and lerps them into the running mean in place, as the
JAX app takes its megakernel on a TPU. The CPU takes the kernel's plain
version, and the volumetric variant the eager wavefront.

Usage::

    python -m bifrost3d_tpu_torch.apps.smallpt_app -n 64 -o build/smallpt.png
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import torch

from bifrost3d_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=8)
def _scene(device: torch.device, volumetric: bool):
    """The app's sphere scene on ``device``, built once, so that a later
    render finds the kernel's tables for it on the card already."""
    from bifrost3d_tpu_torch.scene.spheres import smallpt_scene, smallvpt_scene
    return (smallvpt_scene if volumetric else smallpt_scene)(device=device)


def render_progressive(width: int, height: int, accumulations: int,
                       volumetric: bool = False, quiet: bool = False,
                       device="cuda"):
    """The running mean of ``accumulations`` frames → float32
    [height, width, 3] on ``device``, row 0 at the bottom. Under a
    ``torch.profiler`` session the call is span ``b3d.smallpt.progressive``
    and each accumulation, its frame and its lerp, ``b3d.smallpt.frame``."""
    device = torch.device(device)
    from bifrost3d_tpu_torch.integrator.pallas_smallpt import (
        smallpt_megakernel_accumulate)
    from bifrost3d_tpu_torch.integrator.smallvpt import (
        render_smallvpt_accumulation)
    with span("smallpt.progressive"):
        scene = _scene(device, volumetric)

        buffer = torch.zeros((height, width, 3), device=device)
        t0 = time.perf_counter()
        for n in range(1, accumulations + 1):
            with span("smallpt.frame"):
                if volumetric:
                    frame = render_smallvpt_accumulation(scene, width,
                                                         height, n)
                    # Progressive lerp with 1/n (smallpt.h:144) == running
                    # mean.
                    buffer = buffer + (frame - buffer) / n
                else:
                    # The same lerp, in place (in the kernel on the card).
                    smallpt_megakernel_accumulate(scene, width, height, n,
                                                  buffer)
            if not quiet and (n & (n - 1)) == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                print(f"  {n}/{accumulations} accumulations "
                      f"({n / max(dt, 1e-9):.2f} frames/s)", flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return buffer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("-n", "--accumulations", type=int, default=64)
    p.add_argument("--volumetric", action="store_true",
                   help="smallvpt: homogeneous scattering medium variant")
    p.add_argument("-o", "--output", default="smallpt.png")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda or cpu)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    img = render_progressive(args.width, args.height, args.accumulations,
                             volumetric=args.volumetric, device=args.device)
    dt = time.perf_counter() - t0

    from bifrost3d_tpu_torch.io.image import save_image
    # smallpt's backbuffer row 0 is the bottom; PNG row 0 is the top.
    save_image(args.output, img.flip(0), from_linear=True)
    total_pixels = args.width * args.height * args.accumulations
    print(f"rendered {args.width}x{args.height} n={args.accumulations} "
          f"({'smallvpt' if args.volumetric else 'smallpt'}) on "
          f"{args.device} in {dt:.1f}s "
          f"({total_pixels / dt / 1e6:.1f}M pixel-samples/s) "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
