"""EnvironmentConvolution app: GGX-prefilters an environment map.

Port of ``bifrost3d_tpu/apps/environment_convolution.py``, the counterpart
of ``apps/dev/EnvironmentConvolution/main.cpp``: loads a latlong
environment map (EXR, or PNG decoded without PIL), convolves it with the
GGX lobe at a series of roughness values through
:func:`bifrost3d_tpu_torch.preview.ibl.convolve_environment` (the chain
the preview renderer's IBL uses), and writes one image per level, each
level after the first at half the size of the one before (to 16 pixels).

Usage::

    python -m bifrost3d_tpu_torch.apps.environment_convolution env.exr \\
        --roughness 0.0,0.25,0.5,0.75,1.0 --output-dir out/ [--samples 256]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="GGX-convolve an environment map (IBL prefilter)")
    parser.add_argument("environment", help=".exr/.png latlong map (jpg "
                        "where PIL is installed)")
    parser.add_argument("--roughness", default="0.0,0.25,0.5,0.75,1.0",
                        help="comma-separated roughness per output level")
    parser.add_argument("--samples", type=int, default=256,
                        help="GGX samples per texel")
    parser.add_argument("--output-dir", "-o", default=".")
    parser.add_argument("--format", choices=("exr", "png"), default=None,
                        help="output format (default: match the input)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to convolve on (cuda or cpu)")
    args = parser.parse_args(argv)

    from bifrost3d_tpu_torch.io.image import (
        load_exr,
        load_image,
        save_exr,
        save_image,
    )
    from bifrost3d_tpu_torch.preview.ibl import convolve_environment

    device = torch.device(args.device)
    is_exr = args.environment.lower().endswith(".exr")
    env = load_exr(args.environment) if is_exr else load_image(
        args.environment)
    env = torch.as_tensor(np.asarray(env, np.float32)[..., :3], device=device)
    roughness = [float(r) for r in args.roughness.split(",")]

    t0 = time.time()
    mips = convolve_environment(env, roughness_levels=roughness,
                                samples=args.samples)
    out_format = args.format or ("exr" if is_exr else "png")
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.environment))[0]
    for r, mip in mips:
        name = os.path.join(args.output_dir,
                            f"{base}_ggx_{r:.2f}.{out_format}")
        image = mip.cpu().numpy()
        if out_format == "exr":
            save_exr(name, image)
        else:
            save_image(name, image)
        print(f"roughness {r:.2f}: {mip.shape[1]}x{mip.shape[0]} -> {name}")
    print(f"convolved {len(roughness)} levels on {device} in "
          f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
