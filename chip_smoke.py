#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero before
the last line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
2. build: compiles the seven sources of the seven kernels and the post
   chain (csrc/post_chain.cu, csrc/dense_intersect.cu, csrc/mesh_megakernel.cu with its dense and BVH
   instantiations, each with and without the environment, texture and
   cutout branches, csrc/smallpt_megakernel.cu, csrc/bvh_intersect.cu,
   csrc/clustered_intersect.cu and csrc/vmem_intersect.cu; all but B4's and
   B5's include the chunk-culled trace of csrc/dense_trace.cuh) with nvcc into
   build/kernels/, one nvcc each, started together, and
   native/bvh_builder.cpp with g++ into build/native/; prints each build's
   time and ptxas report (registers, stack frame, spills of every
   instantiation).
3. rng: the mesh megakernel's path_rng_4d (megakernel_rng_probe) must
   equal the port's torch path_rng_4d bit for bit on 65,536 seeded (pixel
   hash, dimension) pairs at accumulations 0, 1 and 7; the SmallPT
   kernel's pixel seed and LCG chain (smallpt_rng_probe) must equal
   jenkins_hash / lcg_next bit for bit, states and floats, on 65,536
   seeded pixels x 48 steps at accumulations 1, 2 and 7.
   camera: the megakernel makes its own camera lanes; its prologue
   (megakernel_camera_probe) against path_tracer._camera_lanes at 512²,
   raster order and 8 x 4 tiles, accumulations 0, 1, 7: every pixel
   written once, the pixel hash bit for bit, origin and direction within
   1e-6 of their length.
   trace probe: the megakernel's chunk-culled dense trace
   (megakernel_trace_probe) against the dense trace kernel on Sphere's 962
   triangles and a seeded random 1,024: the same prim on every ray off
   ties, t/u/v bit for bit where prim agrees, the same any-hit occlusion;
   times of both, the culled trace's test counts.
4. kernel: the dense trace kernel against its plain PyTorch version on the
   card, on the CornellBox soup, a 16,130-triangle sphere + floor soup and
   the 49,678-triangle bridge soup, 65,536 camera rays and 65,536 seeded
   incoherent rays each: closest hit with t_max = inf, with a finite
   t_max, and with a live prefix of R/3 as an int and as a device int64;
   prim must agree off ties on >= 99.9% of rays and t be allclose (rtol
   1e-5) where it does, u and v within 1e-3 on >= 99.9% of the hits where
   it does (_compare_uv), and rays past the prefix miss. Median call times by CUDA events,
   device times by torch.profiler (in a process of its own, with the
   cluster scan's and the resident-cluster walk's: a later profiler session
   of one process has lost the card's trace), the plain cull's work
   (group-box, chunk-box and triangle
   tests, chunks read) and two bounds: the full scan's and this work's.
5. wavefront: CornellBox 512², 4 bounces, one accumulation through
   render_sample_pooled, the path of scenes the megakernel does not take;
   the trace kernel's launch count must rise. One accumulation with the
   trace forced to the plain version must pass the statistical gate of
   tests/test_pallas_mesh.py:25-42 against the kernel's; pooled frame
   time and rays/s are printed.
6. megakernel: CornellBox and SphereLight at 512² and Veach, Veach
   mesh-light and the coated, spot-light, Default+Diffuse, emissive and
   directional-light test scenes at 256², 4 bounces, one accumulation
   each: the kernel (its own camera lanes) against its plain version (the
   torch lanes; the same RNG bits, only FMA contraction differs: at most
   0.2% of pixels off by > 1e-3, means within 0.5%) and against the pooled
   wavefront (the statistical gate: 3%, 2%), ray counts within 2% of the
   wavefront's.
7. progressive: CornellBox 512² × 8 accumulations through
   render_progressive, the main path: the megakernel's launch count must
   rise by exactly 8, the image be finite and lit and bit-equal to the
   eager loop's (render_sample_fast's frames lerped by torch), and the
   kernel's lerp hold against the plain version's over accumulations 0 and
   1, each from the plain running mean so far (0.2%, 0.5%); it is
   tonemapped and written to build/cornell_512.png; peak memory is
   printed.
8. kernel/smallpt: the SmallPT megakernel at 1024 x 768, accumulations 1
   and 2, against its plain version (the eager wavefront over all
   pixels): share of pixels off by > 1e-4 and relative gap of the means,
   both gated; the app's entry smallpt_megakernel_accumulate (the running
   mean lerped in the kernel) at accumulations 1-3, each launch given the
   plain version's running mean so far: under the same gates against
   smallpt_megakernel_accumulate_reference, and bit for bit the write
   branch's frame lerped by torch; the launch alone (its memset and the
   kernel) on the wrapper's cached sphere table and camera, bit for bit
   the wrapper's frame; the persistent grid's blocks per SM.
9. kernel/bvh: the BVH trace kernel on the 589,824-triangle torus grid
   with 65,536 coherent camera rays and 65,536 seeded incoherent rays:
   closest hit, any-hit, and the sorted wrapper, each against the plain
   version (the lockstep traversal over the same packed tree): prim must
   agree off ties (two candidates whose t agree to 1e-6 relative) on
   >= 99.9% of rays and t within rtol 1e-5 where it does, u and v as in
   phase 4; occlusion must agree on >= 99.9%; the live prefix (a device int64 and an int) honoured
   by closest and any-hit queries; and against the dense kernel on the
   16,130-triangle soup. The persistent grid's blocks per SM, median
   times, the plain walk's box and triangle test counts.
10. smallpt: smallpt_app.render_progressive(1024, 768, 8) on the card,
   main path A: exactly 8 SmallPT-kernel launches, the image finite and
   lit and written to build/smallpt_1024x768.png; a second render of 8
   frames under torch.profiler with torch's sync debug mode raising: 8
   SmallPT kernels, at most one kernel-launch call and one memset a frame
   (and the buffer's fill), no host-device copy, at most one host
   synchronise (the return's).
11. torus_grid: the 589,824-triangle scene at 512², 4 bounces through
   render_sample_fast, main path B: explain_render_path, BVH-kernel
   launches > 0 and dense-kernel launches 0 on that frame, wavefront
   steps, frame time and rays/s (and, in turns, the frame time without the
   pool sort), scene-build seconds, peak memory; at 128²
   the frame must pass the statistical gate against the same frame traced
   with the plain version.

12. kernel/clustered and kernel/vmem: the cluster scan and the
   resident-cluster walk on the 49,678-triangle bridge scene's soup with
   its 65,536 camera rays and 65,536 seeded incoherent rays, and on the
   16,130-triangle soup: each against its plain version (prim equal off
   ties on >= 99.9% of rays, t within rtol 1e-5, u and v as in phase 4;
   the walk also with a
   finite t_max, its occlusion on >= 99.9%, its any-hit prim also under
   the closest-hit gate, each hit at the distance of the triangle it
   names, its live prefix as an int, an int32 and an int64 tensor) and against the dense and the BVH kernel on
   the same rays; each one's plain model of its cull equal to its plain
   version bit for bit; median call times of all four traces side by side
   and both kernels' device times (torch.profiler, in the process of phase
   4), the plain versions' work counts (block fetches or probes and leaves,
   padded cluster boxes, chunk boxes and triangles tested per ray) and two
   bounds each: the TPU design's and the kernel's own work's.
13. megakernel/hier: the 2,494-triangle mid-size scene and the three bridge
   scenes (3,054, 14,606 and 49,678 triangles) at 256², 4 bounces through
   the megakernel's BVH branch: the kernel against its plain version on the
   same lanes (at most 0.2% of pixels off by > 1e-3, means within 0.5%) and
   against the pooled wavefront (3%, 2%), ray counts within 2%; the
   largest also at 512², its lanes in 8 x 4 pixel tiles, against its plain
   version (0.2%, 0.5%), with the median kernel time (CUDA events), the
   plain version's time (one run), its box and triangle test counts and the
   bound: the kHier instantiation without kExtras, which no cell runs.
   walk: the BVH branch's walk alone as the megakernel's library builds it
   (megakernel_hier_trace_probe) against the BVH trace kernel, which walks
   the same child records, on the trees of the 49,678-triangle bridge,
   hier_bridge_15k_env and torus_grid_28, with each scene's 512² camera
   rays and 262,144 seeded incoherent rays: t, prim, u, v bit for bit,
   closest hit and unbounded any-hit; on the bridge both walks' times.
14. hier_bridge: the 49,678-triangle scene at 512², 4 bounces, 8
   accumulations through render_progressive, main path C:
   explain_render_path says megakernel, exactly 8 megakernel launches and
   no launch of a trace kernel, the image bit-equal to the eager loop's
   (phase 7); a render_sample_fast frame against one pooled-wavefront
   frame (the statistical gate; the pooled frame's time); the other two
   bridge scenes and the 258,048-triangle torus_grid_28 three frames each,
   one megakernel launch a frame.
15. packings: one pooled-wavefront frame of the 14,606-triangle bridge
   scene at 256² with tri_clustered set to the cluster-scan packing and one
   with the resident-cluster packing: launches of the right kernel > 0, of
   the other trace kernels 0, the frame under the statistical gate against
   the dense trace's.
   pooled: the same scene at 512², 4 bounces, one pooled frame on its
   default dense table (B1), one on the cluster-scan packing (B6) and one
   on the resident-cluster packing (B7), each in a process of its own
   after a first frame: frame time, the trace kernel's launches (the other
   trace kernels' 0) and its share of the frame's device time
   (torch.profiler); a packing's frame finite, lit and under the
   statistical gate against the dense table's frame of the same
   accumulation.

16. megakernel/extras: the megakernel's environment, texture and cutout
   branches (its kExtras instantiations): Sphere, sphere_sun, Opacity and
   textured_cornell at 256² on the dense trace, hier_bridge_15k_env,
   opacity_hier, MaterialScene and MaterialSceneLegacy (a NEAREST checker
   floor; MaterialScene with its spheres, SHADERBALL_PATH pointed at no
   file, here and on main path D) on the BVH trace, 4 bounces, settings_for_scene's settings
   (coverage-aware shadows where the scene is semi-transparent): for each,
   explain_render_path (megakernel), the kernel against its plain version
   on the same lanes (at most 0.2% of pixels off by > 1e-3, means within
   0.5%) and against the pooled wavefront (3%, 2%), ray counts within 2%;
   Opacity's mean above 1e-4; the checker must show on textured_cornell's
   floor (a row's maximum over twice its minimum).
17. extras paths, main path D: Sphere and Opacity, then
   hier_bridge_15k_env, MaterialScene and MaterialSceneLegacy, each 512²,
   4 bounces, 8 accumulations through render_progressive, tonemapped and
   written as a PNG: exactly 8 launches of the megakernel's kExtras
   instantiation and no launch of a trace kernel; the kernel at the path's
   shape against its plain version (at most 0.2% of pixels off by > 1e-3,
   means within 0.5%); the running mean bit-equal to the eager loop's and
   the kernel's lerp against the plain version's, as in phase 7. On Sphere
   and Opacity, the dense trace's kExtras instantiation, which no cell
   runs: the kernel's median time (CUDA events) beside its plain version's
   (one run) and its bound, which counts the shadow traces that the plain
   version made (one any-hit query per lit shaded hit, or the march's steps
   one by one) and the tables' bytes.
18. viewer: apps/simple_viewer --scene Sphere and --scene Opacity at its
   defaults' size (512², 4 bounces) with -n 8, the entry point of main
   path D: exactly 8 megakernel launches and no trace-kernel launch each,
   a PNG written. The viewer renders with a plain RenderSettings (binary
   shadow rays, as the reference viewer), so one frame of Opacity at these
   settings is also held against the plain version.
19. profile: render_sample_fast at 512² after a scene's first frame, for
   CornellBox, Sphere, Opacity and the bridge: CUDA launches (at most 10)
   and host syncs (none) per frame from torch.profiler over three frames,
   with torch's sync debug mode raising on a synchronising op. Then warm
   calls of the resident-cluster walk
   (closest and any-hit, bounds and the live count on the device) under
   the same mode: one kernel launch and no host sync a call.
20. train, main path E (gradients): bench.py's bench_backward step in
   the port, the loss mean((render_sample - target)²) and its gradient
   over materials.tint, on CornellBox at 256², 2 bounces, three steps each
   plain, under the detached-replay VJP and under remat: finite gradients,
   exactly 10 B1 launches in each forward and none in a plain or replay
   backward (10 again in remat's), replay's and remat's losses bit for bit
   plain's and their gradients within rtol 1e-5, atol 1e-8; the median
   step time and the peak memory of each. The plain step with the trace on
   its plain version: the gradient within 1e-3 of the largest component.
   The 589,824-triangle torus grid at 256², one plain step: B4 launches,
   no B1, a finite non-zero gradient. optimize_materials on
   tests/test_diff.py's scene: test_recover_tint's gate at its 16 x 12
   and 16 Adam steps; at 64 x 48, 8 steps, the losses against the same run
   on the plain trace. The edge gradients of a single sphere and of a floating box
   against central differences of their forwards, with JAX's tolerances.
   One step each of plain, replay and remat at 512², 4 bounces: step time
   and peak memory. Then the B1 kernels torch.profiler sees in each
   forward and backward (in a process of its own; each part between spin
   kernels on the card's timeline), equal to the counts.
21. viewer_scenes: the four scenes that load since the Transmissive model
   and the material scenes. Glass and Test each through render_progressive
   at the viewer's defaults (512², 4 bounces, a plain RenderSettings) × 2
   accumulations, every count at 0 before: explain_render_path, the pooled
   wavefront ("wavefront: Transmissive shading model", B1 launched, no
   megakernel), each frame finite and lit, render_sample_fast's frame
   time. MaterialScene and MaterialSceneLegacy ran on main path D (phase
   17: the megakernel's BVH branch in its kExtras instantiation, one B3
   launch a frame, held against its plain version at 512²); their lines
   here repeat that phase's path, launches and gate. Then a 64²
   Glass frame on the card against the same frame on the CPU,
   where the plain B1 runs, under the statistical gate (≤ 3% of pixels off
   by > 1e-3, means within 2%). Then the JAX-rule clip helpers
   (math/clip.py) on card tensors, in a process of their own: no
   host-to-device copy (torch.profiler) and no host sync (sync debug mode
   raising) a call.
22. files: the viewer on files written under build/files/ from seeded
   numpy (the repository holds no model files), at its defaults (512², 4
   bounces), each run with every count at 0 before. F1: the bridge scene's
   49,678 triangles as bridge.obj (v / vt / vn, one usemtl group per
   material, an MTL with Kd, Ns, illum and d), loaded through the native
   tokenizer and the Python one (equal arrays, the triangles those
   written), then simple_viewer --scene bridge.obj -n 8: exactly 8
   megakernel launches (its BVH branch, B3), no trace launch; a 512² frame
   against its plain version. F2: the 589,824-triangle torus grid as
   torus.glb (POSITION, NORMAL, TEXCOORD_0 interleaved in one view of
   stride 32; 1024² RGBA base-colour and metallic-roughness PNGs,
   Paeth-filtered, in the binary chunk; alphaMode MASK), no glTF warning,
   3 textures in the bank, the viewer -n 2 on the pooled wavefront (B4
   launched, no other kernel), a 128² frame against the plain trace. F3: a
   1024 x 512 sky with a sun written by save_exr and read back bit for
   bit, as --environment-map on CornellBox and on bridge.obj -n 2: the
   pooled wavefront, B1 launched, no other kernel; a 128² frame of each
   against the plain trace. F4: render_aovs at 512² on bridge.obj (one B1
   launch) and torus.glb (one B4 launch) against the plain trace: prim off
   ties and u, v as in phase 4; tint, roughness and primitive id equal and
   depth within the t gate where prim agrees; shading normal and albedo
   within 1e-3 on >= 99.9% of those pixels; the viewer's --aov for each of
   the six on bridge.obj and primitive_id on torus.glb, written as EXR and
   read back equal. Each case prints its load seconds (native and Python
   tokenizer, glTF accessors, PNG decode, EXR read), on the paths without
   a megakernel (F2, F3) render_sample_fast's frame ms (median of 3, with
   the range) and each kernel's launches a frame, beside the card's name
   and power limit.

23. viewer_modes: every mode of the viewer at its defaults (512², 4
   bounces; accumulations cut), each item with every count at 0 before,
   demanding its kernel and no other; card against CPU at 64². V1: the
   viewer --path-regularization 1.0 -n 2 on CornellBox (the pooled
   wavefront, "path regularization" named, B1), a frame's ms, the 64²
   frame without and with path_regularization_decay 0.5 under the
   statistical gate. V2: tests/test_textures.py's distant floor with a
   1024² trilinear checker at 0 and 4 bounces (B1), frame ms, the 64²
   gate, and level 0's row spread below the horizon over twice
   trilinear's. V3: --renderer denoised -n 8 on CornellBox (the viewer,
   8 B2 launches) and DenoisedBackend on hier_bridge_15k_env (8 B3), one
   AOV trace each (the scene's trace kernel), the à-trous filter alone
   (CUDA events) and a denoised render(); at 64² the AOVs, the running
   mean and the denoised image against the CPU's filter. V4: --renderer
   preview on CornellBox, Sphere and Opacity, render_preview on the
   49,678-triangle bridge (B1) and the torus grid (B4): layers × (1 +
   lights) trace launches a frame, frame ms, 64² card vs CPU (≤ 1% of
   pixels off by > 1e-3 without SSAO, ≤ 5% with it, means within 0.5%). V5: -n 8 --checkpoint-every 4, then -n 12
   resumed at accumulation 8, bit for bit an uninterrupted -n 12. V6:
   environment_convolution on the 1024 x 512 EXR sky, 5 levels, 256
   samples (seconds), each level of a 64 x 32 sky against the CPU's;
   dual-kawase bloom + process_stateful over 8 frames of a 512² HDR frame
   (ms, card vs CPU within 1e-5).

24. engine: the engine and the live viewer (core/, scene/datamodel,
   core/compositor, apps/interactive_viewer) at the viewer's size (its
   Sphere and Box datamodel scenes, the compositor at 512², 3 bounces, the
   app's three renderers), each item with every count at 0 before. E1:
   Sphere (2,210 triangles) through Compositor.attach(Engine), PathTracer,
   8 ticks: exactly 8 B3 launches and no other; B3 on the SceneSync-built
   scene against its plain version at 256² (≤ 0.2% of pixels off by >
   1e-3, means within 0.5%); the 8-tick HDR screenshot of a 64²
   compositor card vs CPU (3%, 2%); tick ms as the median of the last 4,
   split into sync, render and post (utils/profiling). E2: edits on E1's
   scene, 2 ticks each — a material tint, a light's power, the sphere's
   node moved (the BVH refit), the environment tint, a mesh added (a full
   rebuild) and an environment map (no presampled pool, as the JAX
   package: the pooled wavefront on B1): SceneSync ms, the first frame's
   ms, accumulation restarting at 1, explain_render_path, the stores of
   the megakernel's _PACK_CACHE (none but for the refit and the rebuild)
   and _FRAME_CACHE; the refit scene against a full build of the same
   datamodel: the soup equal, B3's walk's hits on 65,536 camera rays off
   ties (≥ 99.9%), a frame of each (3%, 2%), the repack's ms. E3: Box
   with a second camera at z-index 1 on Preview: frames in z-order, B2
   launches = ticks, B1 = ticks × (1 + lights); a 'w' through
   CameraNavigation restarts only the first camera, and handle_updates
   returns the same RenderScene. E4: the settings panel on Sphere:
   Preview (B1 2 a frame), Denoised (B3 a frame, the AOV trace B1 once),
   PathTracer, max bounces + 1 (accumulation restarts), path
   regularization 0.5 (the pooled wavefront, B1). E5: python -m
   bifrost3d_tpu_torch.apps.interactive_viewer --scene Sphere --ticks 12
   --keys wwdpxp at 96x54 and 512x512, each in a process of its own: exit
   0, nothing printed (as the JAX app without a terminal), the screenshot
   PNG finite and lit.

25. parallel: parallel/ on the card, each case with every count at 0
   before. P1: make_sharded_render on CornellBox at 512², 4 bounces, over
   the mesh [cuda:0] * 4, and at 512 x 509 (rows padded to a multiple of
   4 and cropped), each against the unsharded render_pixels_pooled frame
   (max |d| <= 1e-5; bit-equality printed), B1 launched and B4 not. P2:
   the 589,824-triangle torus grid at 512² over 2 shards, B4 launched, the
   same gate. P3: make_sharded_smallpt at 1024 x 768 over 4 shards
   against the unsharded plain frame. P4: three steps of
   make_sharded_train_step (the material and light parameters, lr 5e-3)
   on bench_backward's scene (CornellBox 256², 2 bounces) over 2 shards:
   the first step's loss and gradients against one shard's within atol
   2e-6 and rtol 2e-4 (tests/test_parallel.py's all-reduce gate), the
   first update lowering the loss. P5: parallel/distributed.run_selftest with 2 gloo ranks
   on the card, then world size 1 under nccl: each process renders its
   rows of SmallPT and CornellBox over the global mesh, all-reduces a
   checksum and a gradient, and rank 0 holds them against one process's.
   Each case prints its ms and its peak memory.
26. fits: L1: shading/fittings.precompute_fittings at 4,096 samples on the
   card (written to build/shading/), table by table against the port's
   CPU run (the BRDF rho and bounded-VNDF tables within 1e-5, the
   dielectric ones within 1e-2, 1e-4 on average) and, printed, against the shipped
   fittings.npz. L2: shading/ltc_fit.precompute_ggx_ltc, the full 64 x 64
   grid at 200 Nelder-Mead iterations a row (build/shading/ggx_ltc.npz),
   held against the shipped ggx_ltc.npz by the fit's own objective in
   float64: each row's sum at most 2 x the shipped table's, no cell above
   the shipped cell by more than its row's total, and tests/test_ltc.py's
   fit gate (relative L1 to the normalized GGX lobe under 12% at three
   points); the per-cell ratios' quantiles printed. L3: apps/dev_analysis
   all on the card (the SSS profile's integral within 1e-3 of 1).
27. parity: P1, the shader-ball MaterialScene: a two-node glTF (Node5, a
   shell, and Node2, a core, closed 48 x 24 spheres of geometry/creation,
   2,208 triangles each; tests/torch_parity.write_shader_ball)
   written to build/parity/ and named by apps/scenes.SHADERBALL_PATH;
   create_material_scene on the card (seven balls on the textured floor,
   30,914 triangles) must take the
   megakernel's BVH branch and its kExtras instantiation
   (explain_render_path); at 256² one B3 launch against its plain version
   (0.2%, 0.5%) and the pooled wavefront (3%, 2%); then main path D's
   run at 512² x 8 through render_progressive (exactly 8 B3 launches, no
   trace launch, the kernel and the running mean gated as there). P2: B5
   through
   apps/smallpt_app.render_progressive at 64 x 48 x 32 (exactly 32
   launches) against the float64 numpy reference tests/smallpt_reference.py
   with tests/test_smallpt.py's gates: relative RMS < 0.20, > 80% of the
   pixels within 2%, means within 3% (tests/torch_parity.
   assert_float64_reference_gate). P3: the headless interactive viewer
   (run on the card, no terminal) prints nothing, as JAX's, and returns
   a finite frame of its window's size.
28. post: the post chain's two kernels (csrc/post_chain.cu) at 512² with
   the viewer's settings against the eager chain on the card (LDR max abs
   and exposure relative <= 1e-5), with no host sync; launches a call.
   Alone: python3 chip_smoke.py --profile post.

After each phase, or a few phases together, a "time:" line gives the
seconds since the start and since the line before (a run of the whole
script must end within 1,200 s).
Then one JSON line of the kernels' results that no cell times (B1, B4,
B6, B7, B3's kHier instantiation without kExtras and B2's dense one with
kExtras; each kernel's time beside its bound: the larger of its bytes over
3.35 TB/s and its float32 operations over 67 TFLOP/s, counted from this
run's inputs), and last the JSON result line. The benchmark's cells time
B2 without kExtras (CornellBox), B3 with kExtras (MaterialScene), B5 and
the post chain (BENCHMARK.json, benchmark/run.py); this script gates them.
The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

# One yardstick with the benchmark, from benchmark/harness/: the published
# peaks of one H100 SXM (HBM bytes/s, float32 FLOP/s outside the tensor
# cores), a Möller–Trumbore test and a slab test, the megakernel's shading
# operations (shade_ops), and the spin kernel that marks a profiled range on
# the card's clock. shade_ops' counts were taken once from
# csrc/mesh_megakernel.cu (an add, a multiply, a compare or an integer op is
# one, a fused multiply-add two). An iteration that shades a hit, outside
# its traces: two path_rng_4d draws (~450 integer operations each: pcg2d,
# two Owen scrambles, the 32-bit Sobol loop over four dimensions), the
# attributes and the shading frame (~125), shading_create (~100), the BSDF
# sample with its evaluation (~330), the light hits, offsets and throughput
# (~95): ~1,600. Per RIS candidate a light sample, shading_evaluate, MIS and
# the reservoir: ~360. The coat lobe adds ~150 at creation and ~120 per
# candidate, the kExtras branches (a map or texture fetch, coverage) ~100.
from benchmark.harness.profiling import spin
from benchmark.harness.roofline import (
    BOX_FLOPS, MT_FLOPS, PEAK_BYTES, PEAK_FLOPS, least_time_s, shade_ops)

REPO = os.path.dirname(os.path.abspath(__file__))
R = 65536
RES = 512
SMALL_RES = 256
ACCUMULATIONS = 8
BOUNCES = 4
SOURCES = ("dense_intersect.cu", "mesh_megakernel.cu",
           "smallpt_megakernel.cu", "bvh_intersect.cu",
           "clustered_intersect.cu", "vmem_intersect.cu", "post_chain.cu")
SMALLPT_W, SMALLPT_H = 1024, 768
TORUS_RES = 512
TORUS_TRIS = 589824
# TEST_SCENES too large for the dense megakernel: main paths B and C drive
# them.
HIER_SCENES = ("mid_size", "hier_bridge_3k", "hier_bridge_15k",
               "hier_bridge_50k")
BRIDGE_SCENE, BRIDGE_TRIS = "hier_bridge_50k", 49678
LARGE_SCENES = ("torus_grid", "torus_grid_28") + HIER_SCENES
# The scenes of the environment, texture and cutout branches (main path D
# and its gates): name, whether a viewer scene (SCENES) or a TEST_SCENES one.
# The two material scenes (a NEAREST checker floor, BVH trace) are viewer
# scenes of main path D since the Transmissive slice; phase 21 reports them.
MATERIAL_SCENES = ("MaterialScene", "MaterialSceneLegacy")
EXTRAS_SCENES = (("Sphere", True), ("sphere_sun", False), ("Opacity", True),
                 ("textured_cornell", False), ("hier_bridge_15k_env", False),
                 ("opacity_hier", False)) + tuple(
                     (name, True) for name in MATERIAL_SCENES)
EXTRAS_PATHS = ("Sphere", "Opacity", "hier_bridge_15k_env") + MATERIAL_SCENES
# SmallPT kernel vs its plain version: share of pixels off by > 1e-4 and
# relative difference of the means.
SMALLPT_FLIPS, SMALLPT_MEAN = 0.02, 0.003
# Kernel vs its plain version on the same inputs: share of pixels off by
# > 1e-3, and relative difference of the means.
KERNEL_FLIPS, KERNEL_MEAN = 0.002, 0.005


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the port on a CUDA card only", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
          f" | cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def smi() -> str:
    """The card's SM clock, power draw and power limit now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def roofline(n_bytes: float, flops: float) -> dict:
    """least_time_s of the work in ms, and which of the two limits sets
    it."""
    by_bytes = n_bytes / PEAK_BYTES >= flops / PEAK_FLOPS
    return dict(bound_ms=least_time_s(flops, n_bytes) * 1e3,
                bound_by="bytes" if by_bytes else "operations")


def build_phase() -> None:
    from bifrost3d_tpu_torch.geometry import native
    from bifrost3d_tpu_torch.utils import cuda_build

    def build(source):
        t0 = time.perf_counter()
        path = cuda_build.build(source)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, SOURCES))
    for source, (path, seconds) in zip(SOURCES, built):
        with open(os.path.splitext(path)[0] + ".log") as f:
            ptxas = " ".join(line.strip() for line in f
                             if "registers" in line or "spill" in line)
        print(f"build: {source} in {seconds:.2f} s -> "
              f"{os.path.relpath(path, REPO)} | {ptxas}", flush=True)
    t0 = time.perf_counter()
    check(native.native_available(), "the native BVH builder did not build "
          "(g++): the numpy builder would take minutes on the torus grid")
    print(f"build: native/bvh_builder.cpp in {time.perf_counter() - t0:.2f} s"
          f" -> {os.path.relpath(native.library_path(), REPO)}", flush=True)


def rng_phase(device) -> None:
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.sampling.sobol import path_rng_4d
    rng = np.random.default_rng(1)
    hashes = torch.tensor(rng.integers(0, 2**32, R), device=device)
    dims = torch.tensor(rng.integers(0, 64, R), device=device)
    for acc in (0, 1, 7):
        got = mega.rng_probe(acc, hashes, dims)
        ref = path_rng_4d(acc, hashes, dims)
        torch.cuda.synchronize()
        same = int((got.view(torch.int32) == ref.view(torch.int32)).sum())
        check(same == got.numel(), f"rng at accumulation {acc}: "
              f"{got.numel() - same} of {got.numel()} values differ")
    print(f"rng: megakernel path_rng_4d bit-exact with the torch chain on "
          f"{R} (pixel hash, dimension) pairs x 4 at accumulations 0, 1, 7",
          flush=True)

    from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt
    from bifrost3d_tpu_torch.sampling import hashes
    steps = 48
    x = torch.tensor(rng.integers(0, SMALLPT_W, R), device=device)
    y = torch.tensor(rng.integers(0, SMALLPT_H, R), device=device)
    for acc in (1, 2, 7):
        states, floats = spt.rng_probe(x, y, SMALLPT_W, acc, steps)
        index = hashes.u32((y * 2 + (acc >> 1) % 2) * (SMALLPT_W * 2)
                           + x * 2 + acc % 2)
        state = hashes.jenkins_hash(index) ^ int(
            hashes.reverse_bits(hashes.u32(acc)))
        for k in range(steps):
            state, u = hashes.lcg_next(state)
            check(bool(torch.equal(states[k], state)),
                  f"smallpt LCG state differs at step {k}, accumulation {acc}")
            check(bool(torch.equal(floats[k].view(torch.int32),
                                   u.view(torch.int32))),
                  f"smallpt LCG float differs at step {k}, accumulation {acc}")
    print(f"rng: smallpt pixel seed and LCG chain bit-exact with jenkins_hash "
          f"/ lcg_next on {R} pixels x {steps} steps (states and floats) at "
          f"accumulations 1, 2, 7", flush=True)


def camera_phase(device) -> dict:
    """The megakernel's own camera lanes (megakernel_camera_probe) against
    path_tracer._camera_lanes at 512², raster order and 8 x 4 tiles,
    accumulations 0, 1 and 7: every pixel written, the pcg2d hash bit for
    bit, origin and direction within 1e-6 of their length, the same active
    lanes."""
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    _, cam = create_cornell_box(device=device)
    flat = torch.arange(RES * RES, device=device)
    worst = {"origin": 0.0, "direction": 0.0}
    for tile in (None, mega.HIER_PIXEL_TILE):
        for acc in (0, 1, 7):
            hashes, o, d, active = mega.camera_probe(
                mega.CameraFrame(cam, RES, RES, tile), acc)
            lanes = pt._camera_lanes(cam, flat % RES, flat // RES, RES, RES,
                                     acc, torch.ones_like(flat,
                                                          dtype=torch.bool))
            torch.cuda.synchronize()
            what = f"camera lanes, tile {tile}, accumulation {acc}"
            check(bool(torch.isfinite(o).all() & torch.isfinite(d).all()),
                  f"{what}: a pixel was not written")
            check(bool(torch.equal(hashes, lanes.pixel_hash)),
                  f"{what}: pixel hashes differ")
            check(bool(torch.equal(active, lanes.active)),
                  f"{what}: active lanes differ")
            for name, got, ref in (("origin", o, lanes.origin),
                                   ("direction", d, lanes.direction)):
                rel = float(((got - ref).abs().amax(dim=-1)
                             / ref.norm(dim=-1)).max())
                check(rel <= 1e-6, f"{what}: {name} off by {rel:.3g} of "
                      "its length")
                worst[name] = max(worst[name], rel)
    print(f"camera: the megakernel's lanes at {RES}x{RES}, raster and "
          f"{mega.HIER_PIXEL_TILE[0]}x{mega.HIER_PIXEL_TILE[1]} tiles, "
          f"accumulations 0, 1, 7 | hash bit-exact | origin within "
          f"{worst['origin']:.3g}, direction within {worst['direction']:.3g} "
          f"of their length (gate 1e-6)", flush=True)
    return worst


def trace_probe_phase(device) -> dict:
    """The megakernel's chunk-culled dense trace (megakernel_trace_probe)
    against the dense trace kernel (B1) on the same table: Sphere's 962
    triangles and a seeded random 1,024, 65,536 rays each. The same prim
    on every ray off ties, t/u/v bit for bit where prim agrees; any-hit
    within a finite t_max gives B1's occlusion on every ray. Times of both
    and the plain version's test counts."""
    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    rng = np.random.default_rng(17)
    random = (rng.uniform(-1.0, 1.0, size=(1024, 1, 3))
              + rng.normal(scale=0.15, size=(1024, 3, 3))).astype(np.float32)
    sphere = SCENES["Sphere"](device=device)[0].tri_verts
    out, inf = {}, float("inf")
    for name, tris in (("sphere", sphere),
                       ("random", torch.tensor(random, device=device))):
        n = int(tris.shape[0])
        table, (comp, _) = mega.dense_table(tris), dense.pack_triangles(tris)
        o, d, _ = _rays(rng, "sphere", device)
        got = mega.trace_probe(table, n, o, d, 1e-4, inf)
        ref = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, inf)
        torch.cuda.synchronize()
        same = got.prim == ref.prim
        tie = ~same & ((got.t - ref.t).abs() <= 1e-6 * ref.t.abs())
        check(bool((same | tie).all()), f"trace probe/{name}: prim differs "
              f"off ties on {int((~(same | tie)).sum())} rays")
        for field in ("t", "u", "v"):
            check(bool(torch.equal(getattr(got, field)[same],
                                   getattr(ref, field)[same])),
                  f"trace probe/{name}: {field} not bit-equal to B1's")
        occ = mega.trace_probe(table, n, o, d, 1e-4, 1.0, any_hit=True)
        occ_ref = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, 1.0)
        check(bool(torch.equal(occ.prim >= 0, occ_ref.prim >= 0)),
              f"trace probe/{name}: any-hit occlusion differs from B1's")
        stats = {}
        mega.culled_dense_intersect_reference(table, n, o, d, 1e-4, inf,
                                              stats=stats)
        ms = _median_ms(lambda: mega.trace_probe(table, n, o, d, 1e-4, inf))
        b1_ms = _median_ms(lambda: dense.dense_intersect_cuda(
            comp, n, o, d, 1e-4, inf))
        hits = float((ref.prim >= 0).float().mean())
        out[name] = dict(ties=int(tie.sum()), ms=ms, b1_ms=b1_ms, hits=hits,
                         tri_tests=stats["tri_tests"] / R,
                         box_tests=stats["box_tests"] / R)
        print(f"trace probe/{name}: {R} rays x {n} tris | prim equal to "
              f"B1's off ties on every ray ({int(tie.sum())} ties), t/u/v "
              f"bit-equal where equal, any-hit occlusion equal | hit share "
              f"{hits:.3f} | culled trace {ms:.4f} ms vs B1's full scan "
              f"{b1_ms:.4f} ms (median of 20) | "
              f"{out[name]['tri_tests']:.1f} triangle and "
              f"{out[name]['box_tests']:.1f} chunk-box tests per ray "
              f"(full scan: {n})", flush=True)
    return out


def _soups(device):
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry.creation import make_plane, make_sphere
    from bifrost3d_tpu_torch.geometry.mesh import transform_mesh
    cornell = create_cornell_box(device=device)[0].tri_verts
    sphere = make_sphere(radius=0.5, slices=128, stacks=64)
    floor = transform_mesh(make_plane(size=4.0), np.asarray(
        [[1, 0, 0, 0], [0, 1, 0, -0.5], [0, 0, 1, 0]], np.float32))
    soup = np.concatenate([m.positions[m.indices] for m in (sphere, floor)])
    return {"cornell": cornell,
            "sphere": torch.tensor(soup, dtype=torch.float32, device=device)}


def _rays(rng, name, device):
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if name == "cornell":
        # In the room's free space above both boxes: a ray starting inside
        # a box would see the box's bottom face coplanar with the floor, a
        # tie that FMA contraction resolves either way.
        o = rng.uniform((-0.45, 0.12, -0.45), (0.45, 0.45, 0.45),
                        size=(R, 3)).astype(np.float32)
    else:                   # around the sphere, aimed near its centre
        o = rng.normal(size=(R, 3)).astype(np.float32)
        o = 1.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        aim = -o + rng.normal(scale=0.4, size=(R, 3)).astype(np.float32)
        d = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    t_max = rng.uniform(0.2, 1.5, size=R).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (o, d, t_max)]


def _median_ms(fn, repeats=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _device_ranges(events, names) -> dict:
    """The device events of a torch.profiler session split at its spin
    kernels (one ``spin`` before each range and one after the last) into
    the ranges ``names``, in order → {name: [event, ...]}, spins left
    out; None where the session holds no spin kernel (the card's trace
    was lost). The host's clock cannot place device events: its mapping
    onto the card's has put the kernels of one range into the host window
    of its neighbour. The benchmark's ``profiling.segment`` reads one
    range, between the first spin and the last; this splits one session
    into several, as device_ms and _walk_call_profile need."""
    cuda = torch.autograd.DeviceType.CUDA
    on_card = sorted((e for e in events if e.device_type == cuda),
                     key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(on_card) if "spin_kernel" in e.name]
    if not spins:
        return None
    check(len(spins) == len(names) + 1, f"profile: {len(spins)} spin kernels "
          f"on the card for {len(names)} ranges")
    return {name: on_card[first + 1:last]
            for name, first, last in zip(names, spins, spins[1:])}


def device_ms(workloads, repeats=10) -> dict:
    """Device time per call of the kernels each workload launches, torch's
    own kernels and memsets left out: one torch.profiler session over all
    of them (the card's trace has been seen to go missing in a later
    session of one process), each workload's calls ending in a synchronise
    between spin kernels, kernels assigned to the range they run in on the
    card's clock. None where the trace holds no kernel of a workload."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in workloads:
            spin()
            with record_function(f"workload:{name}"):
                for _ in range(repeats):
                    fn()
                torch.cuda.synchronize()
        spin()
        torch.cuda.synchronize()
    ranges = _device_ranges(prof.events(), [name for name, _ in workloads])
    check(ranges is not None, "torch.profiler saw nothing on the card")
    # On the card each range is also an annotation spanning its kernels,
    # which is no kernel.
    total = {name: sum(e.time_range.elapsed_us() for e in inside
                       if not any(word in e.name for word in
                                  ("workload:", "at::", "Memset", "Memcpy")))
             for name, inside in ranges.items()}
    return {name: (us / repeats / 1e3 if us else None)
            for name, us in total.items()}


def _pinhole_rays(eye, target, fov, device, side=256):
    """side² camera rays from ``eye`` towards ``target`` through a square
    window of half-angle tangent ``fov``, in raster order."""
    eye, target = np.asarray(eye, np.float32), np.asarray(target, np.float32)
    w = target - eye
    w /= np.linalg.norm(w)
    u = np.cross(w, [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(u, w)
    xs, ys = np.meshgrid(np.linspace(-fov, fov, side),
                         np.linspace(fov, -fov, side))
    d = (xs[..., None] * u + ys[..., None] * v + w).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(eye, d.shape).copy()
    return torch.tensor(o, device=device), torch.tensor(d, device=device)


def _dense_cases(device, soups):
    """The dense kernel's tables and ray sets: CornellBox (its camera at
    256² and rays from the room's free space), the 16,130-triangle sphere
    and floor (a camera on the sphere and rays from around it) and the
    49,678-triangle bridge (_bridge_rays), 65,536 rays each."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES, create_cornell_box
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    rng = np.random.default_rng(0)
    scene, cam = create_cornell_box(device=device)
    lanes = mega.megakernel_inputs(scene, cam, 256, 256, 0,
                                   pt.RenderSettings(max_bounce_count=1))
    yield "cornell", soups["cornell"], {
        "camera": (lanes[6].contiguous(), lanes[7].contiguous()),
        "incoherent": tuple(_rays(rng, "cornell", device)[:2])}
    yield "sphere", soups["sphere"], {
        "camera": _pinhole_rays((0.4, 0.6, 1.6), (0.0, -0.1, 0.0), 0.45,
                                device),
        "incoherent": tuple(_rays(rng, "sphere", device)[:2])}
    scene, cam = TEST_SCENES[BRIDGE_SCENE](device=device)
    yield "bridge", scene.tri_verts, _bridge_rays(scene, cam, device)


def kernel_phase(device, soups, device_times) -> dict:
    """B1 against its plain version on three tables and two ray sets each;
    call times, device times (``device_times``: trace_device_phase's, from
    a process of its own), the plain cull's work and both bounds."""
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    results, failures = {}, []
    inf = float("inf")
    live = R // 3
    for name, tris, ray_sets in _dense_cases(device, soups):
        comp, n = dense.pack_triangles(tris)
        n_chunks, n_groups = dense.box_counts(n)
        for ray_name, (o, d) in ray_sets.items():
            what = f"{name}/{ray_name}"
            ref = dense.dense_intersect_reference(comp, n, o, d, 1e-4, inf)
            t_max = _bounded(ref)
            worst_err, worst_agree, ties, got = 0.0, 1.0, 0, {}
            uv_agree, uv_err = 1.0, 0.0
            for case, bound, count in (
                    ("inf", inf, None), ("t_max", t_max, None),
                    ("live", inf, live),
                    ("live64", inf, torch.tensor(live, device=device))):
                got[case] = dense.dense_intersect_cuda(comp, n, o, d, 1e-4,
                                                       bound, count)
                plain = ref if case == "inf" else \
                    dense.dense_intersect_reference(comp, n, o, d, 1e-4,
                                                    bound, count)
                rows = slice(None) if count is None else slice(0, live)
                got_rows = type(ref)(*(f[rows] for f in got[case]))
                plain_rows = type(ref)(*(f[rows] for f in plain))
                a, t, err = _compare_hits(got_rows, plain_rows,
                                          f"dense/{what}/{case}", failures)
                uv_a, uv_e = _compare_uv(got_rows, plain_rows,
                                         f"dense/{what}/{case}", failures)
                worst_agree, ties = min(worst_agree, a), ties + t
                worst_err = max(worst_err, err)
                uv_agree, uv_err = min(uv_agree, uv_a), max(uv_err, uv_e)
                if count is not None and not bool(
                        (got[case].prim[live:] == -1).all()):
                    failures.append(f"dense/{what}/{case}: rays past the "
                                    "live count must miss")
            if not all(torch.equal(x, y)
                       for x, y in zip(got["live"], got["live64"])):
                failures.append(f"dense/{what}: the live count as an int and "
                                "as an int64 tensor give other hits")
            stats = {}
            dense.culled_dense_intersect_reference(comp, n, o, d, 1e-4, inf,
                                                   groups=True, stats=stats)
            ms = _median_ms(lambda: dense.dense_intersect_cuda(
                comp, n, o, d, 1e-4, inf))
            plain_ms = _median_ms(lambda: dense.dense_intersect_reference(
                comp, n, o, d, 1e-4, inf), repeats=3, warmup=1)
            read = min(n, stats["chunks_read"] * dense.CHUNK)
            # Full scan: rays in (32 B), hits out (16 B), the 9-row table
            # once; one test per ray and triangle. Own work: origin and
            # direction in (24 B), hits out (16 B), the boxes and the
            # records of the chunks entered once; a box test per group box
            # and per chunk box of an entered group, a test per triangle of
            # an entered chunk.
            work = roofline(40 * R + 32 * (n_chunks + n_groups) + 48 * read,
                            BOX_FLOPS * (stats["group_tests"]
                                         + stats["box_tests"])
                            + MT_FLOPS * stats["tri_tests"])
            full = roofline(48 * R + 36 * n, MT_FLOPS * R * n)
            k = results[what] = dict(
                n_tris=n, max_abs_err=worst_err, agree=worst_agree, ties=ties,
                uv_agree=uv_agree, uv_err=uv_err,
                ms=ms, device_ms=device_times[f"dense/{what}"],
                plain_ms=plain_ms, hits=float((ref.prim >= 0).float().mean()),
                bound_full_ms=full["bound_ms"], bound_full_by=full["bound_by"],
                **work, **{key: stats[key] / R for key in (
                    "group_tests", "box_tests", "tri_tests")},
                chunks_read=stats["chunks_read"], n_chunks=n_chunks)
            print(f"kernel/dense/{what}: {R} rays x {n} tris | prim agrees "
                  f"off ties >= {k['agree']:.5f} with the plain version "
                  f"({k['ties']} ties; closest, bounded, live as int and "
                  f"int64), max |dt| "
                  f"{k['max_abs_err']:.3g}, u, v within 1e-3 on "
                  f"{uv_agree:.5f} of hits (max |du|, |dv| {uv_err:.3g}) | "
                  f"hit share {k['hits']:.3f} | "
                  f"call {ms:.4f} ms (median of 20), device "
                  f"{k['device_ms']:.4f} ms (torch.profiler, mean of 10) | "
                  f"plain {plain_ms:.1f} ms (median of 3) | per ray "
                  f"{k['group_tests']:.1f} group-box, {k['box_tests']:.1f} "
                  f"chunk-box and {k['tri_tests']:.1f} triangle tests, "
                  f"{k['chunks_read']} of {n_chunks} chunks read | bound of "
                  f"this work {k['bound_ms']:.5f} ms by {k['bound_by']}, "
                  f"full scan {k['bound_full_ms']:.5f} ms by "
                  f"{k['bound_full_by']}", flush=True)
    check(not failures, "; ".join(failures))
    return results


def _scan_cases(device, soups):
    """The cluster kernels' soups and ray sets: the bridge with
    _bridge_rays, and the 16,130-triangle soup with rays from around it
    (numpy seed 5) → (name, soup, its BVH or None, {ray set: (o, d)})."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    scene, cam = TEST_SCENES[BRIDGE_SCENE](device=device)
    yield "bridge", scene.tri_verts, scene.bvh, _bridge_rays(scene, cam,
                                                             device)
    o, d, _ = _rays(np.random.default_rng(5), "sphere", device)
    yield "sphere", soups["sphere"], None, {"around": (o, d)}


def _bounded(hit):
    """kernel_phase's finite t_max for rays whose closest hits are ``hit``:
    one that cuts some hits short and leaves others."""
    t_max = torch.where(hit.prim >= 0, hit.t * 1.5, 20.0)
    t_max[::2] *= 0.5
    return t_max


def trace_device_phase(device) -> dict:
    """Device times (torch.profiler, one session) of B1's calls on
    kernel_phase's tables and rays and of B6's and B7's on
    cluster_kernel_phase's (B7 also any-hit on the rays bounded by
    _bounded of its closest hits) → {"dense/<table>/<rays>",
    "clustered/<soup>/<rays>", "vmem/<soup>/<rays>" or
    "vmem_any/<soup>/<rays>": ms}. Run in a process of its own."""
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.geometry.bvh import build_soup_bvh
    inf, workloads = float("inf"), []
    soups = _soups(device)
    for name, tris, ray_sets in _dense_cases(device, soups):
        comp, n = dense.pack_triangles(tris)
        for ray_name, (o, d) in ray_sets.items():
            workloads.append((f"dense/{name}/{ray_name}",
                              lambda comp=comp, n=n, o=o, d=d:
                              dense.dense_intersect_cuda(comp, n, o, d, 1e-4,
                                                         inf)))
    for name, tris, bvh, ray_sets in _scan_cases(device, soups):
        bvh = bvh if bvh is not None else build_soup_bvh(tris)
        scan = clustered.pack_clustered(tris, bvh)
        walk = vmem.pack_vmem(tris, bvh)
        for ray_name, (o, d) in ray_sets.items():
            t_max = _bounded(vmem.vmem_intersect_cuda(walk, o, d, 1e-4, inf))
            workloads += [
                (f"clustered/{name}/{ray_name}",
                 lambda scan=scan, o=o, d=d:
                 clustered.clustered_intersect_cuda(scan, o, d, 1e-4, inf)),
                (f"vmem/{name}/{ray_name}",
                 lambda walk=walk, o=o, d=d:
                 vmem.vmem_intersect_cuda(walk, o, d, 1e-4, inf)),
                (f"vmem_any/{name}/{ray_name}",
                 lambda walk=walk, o=o, d=d, t_max=t_max:
                 vmem.vmem_intersect_cuda(walk, o, d, 1e-4, t_max,
                                          any_hit=True))]
    for _, fn in workloads:     # the tables, built at a table's first call
        fn()
    times = device_ms(workloads)
    check(all(ms is not None for ms in times.values()),
          f"torch.profiler saw no kernel of {times}")
    return times


def fresh_process(what: str) -> dict:
    """``chip_smoke.py --profile <what>`` in a process of its own, so that
    its torch.profiler session is the process's first (the card's trace has
    gone missing in a later session of one process) → the dict it prints;
    its other lines are printed here."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile", what],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    results = []
    for line in proc.stdout.splitlines():
        if line.startswith("PROFILE "):
            results.append(json.loads(line[len("PROFILE "):]))
        else:
            print(line, flush=True)
    check(proc.returncode == 0 and bool(results),
          f"chip_smoke.py --profile {what} failed: {proc.stderr[-3000:]}")
    return results[-1]


def _gate(img, ref, what, flip_budget=0.03, mean_budget=0.02):
    """The statistical gate of tests/test_pallas_mesh.py:25-42 → (share of
    pixels off by > 1e-3, max |difference|, relative difference of the
    means)."""
    d = (img - ref).abs().amax(dim=-1)
    flips = float((d > 1e-3).float().mean())
    check(bool(torch.isfinite(img).all()), f"{what}: image is not finite")
    check(flips < flip_budget, f"{what}: {flips:.4f} of pixels differ by "
          "> 1e-3")
    mi, mr = float(img.mean()), float(ref.mean())
    rel = abs(mi - mr) / max(mr, 1e-3)
    check(rel < mean_budget, f"{what}: means {mi} vs {mr}")
    return flips, float(d.max()), rel


def _expect_megakernel(scene, settings, name) -> str:
    """explain_render_path must name the megakernel, and above MAX_TRIS its
    BVH branch, in the JAX package's words."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    path = pt.explain_render_path(scene, settings)
    want = ("megakernel (hier: cluster-BVH DMA trace)"
            if int(scene.tri_verts.shape[0]) > mega.MAX_TRIS else "megakernel")
    check(path == want, f"{name}: {path}")
    return path


def _kernel_frame(scene, cam, res, accumulation, settings):
    """One frame of the kernel, which makes its own camera lanes → (its
    arguments, image [res², 3] and rays [res²] in raster order)."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    args = mega.megakernel_frame_inputs(scene, cam, res, res, accumulation,
                                        settings)
    img, rays = mega.mesh_megakernel_cuda(*args)
    return args, img.reshape(-1, 3), rays


def _plain_frame(scene, cam, res, accumulation, settings, stats=None):
    """The same frame through the plain version on the torch lanes, in
    raster order → (its arguments, image [res², 3], rays [res²])."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    args = mega.megakernel_inputs(scene, cam, res, res, accumulation,
                                  settings)
    r, g, b, rays = mega.mesh_megakernel_reference(*args, stats=stats)
    return args, torch.stack([r, g, b], dim=-1), rays


def _check_eager_mean(name, scene, cam, res, settings, hdr) -> None:
    """render_progressive's running mean ``hdr`` [res, res, 3] (the
    megakernel lerps each accumulation into it, one launch an accumulation)
    must be the eager loop's bit for bit: render_sample_fast's frames, the
    mean lerped by torch."""
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    eager = torch.zeros_like(hdr)
    for n in range(ACCUMULATIONS):
        frame = pt.render_sample_fast(scene, cam, res, res, n, settings)
        eager = eager + (frame - eager) / (n + 1)
    check(torch.equal(hdr.view(torch.int32), eager.view(torch.int32)),
          f"{name}: render_progressive's running mean is not the eager "
          "loop's bit for bit")


def _check_plain_mean(name, scene, cam, res, settings, plain1) -> float:
    """The main path's launch (pallas_mesh.MegakernelAccumulator) against
    the plain version over accumulations 0 and 1, each from the plain
    running mean so far, so that both lerp the same buffer (a pixel whose
    path parts in one frame stays off in a longer mean), under the kernel's
    gates. ``plain1`` is the plain frame of accumulation 1 [res², 3] →
    the larger share of pixels off by > 1e-3."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    _, plain0, _ = _plain_frame(scene, cam, res, 0, settings)
    buffer = torch.zeros((res, res, 3), device=plain0.device)
    accumulator = mega.MegakernelAccumulator(scene, cam, res, res, settings,
                                             buffer)
    mean = torch.zeros_like(plain0)
    worst = 0.0
    for n, frame in enumerate((plain0, plain1)):
        buffer.view(-1, 3).copy_(mean)
        accumulator.accumulate(n)
        mean = mean + (frame - mean) / (n + 1)
        flips, _, _ = _gate(buffer.view(-1, 3), mean,
                            f"{name}: running mean of {n + 1} vs plain",
                            KERNEL_FLIPS, KERNEL_MEAN)
        worst = max(worst, flips)
    return worst


def _reset_counts():
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt
    for module in (dense, mega, hier, spt, clustered, vmem):
        module.reset_launch_count()


def slice_phase(device) -> dict:
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    scene, cam = create_cornell_box(device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    torch.cuda.synchronize()

    # The wavefront path, driven with every count at 0.
    _reset_counts()
    kern = pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    torch.cuda.synchronize()
    launches = dense.launch_count
    check(launches > 0, "the wavefront path launched no trace kernel")
    mean = float(kern.mean())
    check(mean > 0.05, f"image mean {mean} is not lit")

    # One accumulation, kernel trace vs the plain version of the trace.
    with mock.patch.object(dense, "pallas_intersect",
                           dense.dense_intersect_reference):
        plain = pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    flips, _, _ = _gate(kern, plain, "wavefront vs plain trace")

    # Frame time and in-run ray rate of one pooled accumulation.
    frame_ms, rates = [], []
    for acc in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rays = pt.render_sample_pooled_counted(scene, cam, RES, RES, acc,
                                                  settings)
        rays = int(rays)   # synchronises
        dt = time.perf_counter() - t0
        frame_ms.append(dt * 1e3)
        rates.append(rays / dt)

    out = dict(launches=launches, mean=mean, flips=flips,
               frame_ms=statistics.median(frame_ms),
               rays_per_s=statistics.median(rates))
    print(f"wavefront: CornellBox {RES}x{RES} {BOUNCES} bounces pooled | "
          f"trace launches {launches} | mean {mean:.4f} | gate vs plain "
          f"trace: {flips:.4f} flips | frame {out['frame_ms']:.1f} ms, "
          f"{out['rays_per_s'] / 1e6:.2f} M rays/s (median of 3)",
          flush=True)
    return out


def _megakernel_scenes(device):
    from bifrost3d_tpu_torch.apps import scenes
    yield "CornellBox", RES, scenes.create_cornell_box(device=device)
    yield "SphereLight", RES, scenes.create_sphere_light_scene(device=device)
    yield "Veach", SMALL_RES, scenes.create_veach_scene(device=device)
    yield "Veach mesh-light", SMALL_RES, scenes.create_veach_scene(
        with_mesh_light=True, device=device)
    later = LARGE_SCENES + tuple(name for name, _ in EXTRAS_SCENES)
    for name, builder in scenes.TEST_SCENES.items():
        if name not in later:
            yield name, SMALL_RES, builder(device=device)


def megakernel_phase(device) -> None:
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    for name, res, (scene, cam) in _megakernel_scenes(device):
        settings = pt.RenderSettings(max_bounce_count=BOUNCES)
        _expect_megakernel(scene, settings, name)
        _, img, got_rays = _kernel_frame(scene, cam, res, 1, settings)
        _, ref, _ = _plain_frame(scene, cam, res, 1, settings)
        torch.cuda.synchronize()
        flips, max_err, mean_rel = _gate(img, ref, f"{name}: kernel vs plain",
                                         KERNEL_FLIPS, KERNEL_MEAN)
        rays = float(got_rays.sum())
        pooled, pooled_rays = pt.render_sample_pooled_counted(
            scene, cam, res, res, 1, settings)
        wf_flips, _, _ = _gate(img.reshape(res, res, 3), pooled,
                               f"{name}: kernel vs wavefront")
        pooled_rays = int(pooled_rays)
        check(abs(rays - pooled_rays) <= 0.02 * pooled_rays,
              f"{name}: {rays} rays vs the wavefront's {pooled_rays}")
        print(f"megakernel/{name}: {res}x{res} {int(scene.tri_verts.shape[0])}"
              f" tris | vs plain {flips:.5f} flips, max |d| {max_err:.3g}, "
              f"means {mean_rel:.2e} apart | vs wavefront {wf_flips:.4f} "
              f"flips | rays {rays:.0f} vs {pooled_rays} | mean "
              f"{float(img.mean()):.4f}", flush=True)


def progressive_phase(device) -> None:
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    scene, cam = create_cornell_box(device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The main path, driven with every count at 0.
    _reset_counts()
    hdr = pt.render_progressive(scene, cam, RES, RES, ACCUMULATIONS, settings)
    torch.cuda.synchronize()
    launches, trace_launches = mega.launch_count, dense.launch_count
    check(launches == ACCUMULATIONS, f"the main path launched the "
          f"megakernel {launches} times for {ACCUMULATIONS} frames")
    check(hdr.shape == (RES, RES, 3), f"image shape {tuple(hdr.shape)}")
    check(bool(torch.isfinite(hdr).all()), "image is not finite")
    mean = float(hdr.mean())
    check(mean > 0.05, f"image mean {mean} is not lit")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_eager_mean("CornellBox", scene, cam, RES, settings, hdr)
    _, plain1, _ = _plain_frame(scene, cam, RES, 1, settings)
    plain_flips = _check_plain_mean("CornellBox", scene, cam, RES, settings,
                                    plain1)

    ldr = process(hdr, CameraEffectsSettings.preset()._replace(film_grain=0.0))
    png = os.path.join(REPO, "build", "cornell_512.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    save_image(png, ldr)
    check(os.path.getsize(png) > 0, "PNG not written")
    print(f"progressive: CornellBox {RES}x{RES} {BOUNCES} bounces "
          f"x{ACCUMULATIONS} through render_progressive | megakernel "
          f"launches {launches}, trace launches {trace_launches} | mean "
          f"{mean:.4f} | running mean bit-equal to the eager loop's, vs plain "
          f"{plain_flips:.5f} flips | peak {peak_gib:.3f} GiB | "
          f"{os.path.relpath(png, REPO)}", flush=True)


def smallpt_kernel_phase(device) -> None:
    from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt
    from bifrost3d_tpu_torch.scene.spheres import smallpt_scene

    scene = smallpt_scene(device=device)
    w, h = SMALLPT_W, SMALLPT_H
    worst_flips = worst_mean = worst_err = 0.0
    for acc in (1, 2):
        got = spt.smallpt_megakernel_cuda(scene, w, h, acc)
        ref = spt.smallpt_megakernel_reference(scene, w, h, acc)
        torch.cuda.synchronize()
        check(got.shape == (h, w, 3), f"image shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "smallpt image is not finite")
        d = (got - ref).abs().amax(dim=-1)
        flips = float((d > 1e-4).float().mean())
        mean_rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
        check(flips < SMALLPT_FLIPS, f"smallpt accumulation {acc}: {flips:.5f} "
              "of pixels differ from the plain version by > 1e-4")
        check(mean_rel < SMALLPT_MEAN, f"smallpt accumulation {acc}: means "
              f"{float(got.mean())} vs {float(ref.mean())}")
        worst_flips = max(worst_flips, flips)
        worst_mean = max(worst_mean, mean_rel)
        worst_err = max(worst_err, float(d.max()))
    # The app's entry, the running mean lerped in the kernel: each launch
    # gets the plain version's running mean so far, so that both lerp the
    # same buffer.
    plain = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    for n in (1, 2, 3):
        buffer = plain.clone()
        lerped = buffer + (spt.smallpt_megakernel_cuda(scene, w, h, n)
                           - buffer) / n
        spt.smallpt_megakernel_accumulate(scene, w, h, n, buffer)
        spt.smallpt_megakernel_accumulate_reference(scene, w, h, n, plain)
        torch.cuda.synchronize()
        check(torch.equal(buffer.view(torch.int32), lerped.view(torch.int32)),
              f"smallpt accumulate {n}: the running mean is not the frame "
              "lerped by torch bit for bit")
        d = (buffer - plain).abs().amax(dim=-1)
        flips = float((d > 1e-4).float().mean())
        mean_rel = abs(float(buffer.mean()) - float(plain.mean())) / float(
            plain.mean())
        check(flips < SMALLPT_FLIPS, f"smallpt accumulate {n}: {flips:.5f} "
              "of pixels differ from the plain version by > 1e-4")
        check(mean_rel < SMALLPT_MEAN, f"smallpt accumulate {n}: means "
              f"{float(buffer.mean())} vs {float(plain.mean())}")
        worst_flips = max(worst_flips, flips)
        worst_mean = max(worst_mean, mean_rel)
        worst_err = max(worst_err, float(d.max()))
    # The launch alone (its memset and the kernel) on the wrapper's cached
    # inputs: the wrapper's frame bit for bit.
    sph, bsdf, cam = spt.kernel_inputs(scene, w, h)
    out = torch.empty(3 * w * h + 1, dtype=torch.float32, device=device)
    err = spt._library().smallpt_megakernel(
        sph.data_ptr(), bsdf.data_ptr(), int(sph.shape[0]), cam.data_ptr(), w,
        h, 1, 0.0, out.data_ptr(), out[-1:].data_ptr(), spt._THREADS,
        torch.cuda.current_stream(device).cuda_stream)
    check(err == 0, f"smallpt_megakernel launch failed: cudaError {err}")
    check(torch.equal(out[:-1].view(h, w, 3),
                      spt.smallpt_megakernel_cuda(scene, w, h, 1)),
          "the launch's frame is not the wrapper's")
    print(f"kernel/smallpt: {w}x{h}, accumulations 1 and 2, running mean "
          f"1-3 (bit-equal to the frame + torch lerp), the launch alone "
          f"bit-equal to the wrapper | vs plain {worst_flips:.5f} of pixels "
          f"off by > 1e-4, means {worst_mean:.2e} apart, max |d| "
          f"{worst_err:.3g} (a flipped path) | persistent grid of "
          f"{spt.blocks_per_sm()} blocks of {spt._THREADS} per SM", flush=True)


def _torus_rays(device):
    """The two ray sets of the BVH kernel's check: the 65,536 coherent
    camera rays of the JAX package's torus-grid bench, and 65,536 seeded
    rays with origins spread through the grid's box and directions over the
    sphere."""
    from bifrost3d_tpu_torch.apps.scenes import TORUS_GRID_EYE
    xs, ys = np.meshgrid(np.linspace(-1, 1, 256), np.linspace(-1, 1, 256))
    d = np.stack([xs * 0.6, ys * 0.6 - 0.25, np.ones_like(xs)], -1)
    d = d.reshape(-1, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(TORUS_GRID_EYE, np.float32), d.shape).copy()
    rng = np.random.default_rng(3)
    o2 = rng.uniform((-14.0, -2.0, -14.0), (11.0, 4.0, 11.0),
                     size=(R, 3)).astype(np.float32)
    d2 = rng.normal(size=(R, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return {"coherent": (torch.tensor(o, device=device),
                         torch.tensor(d, device=device)),
            "incoherent": (torch.tensor(o2, device=device),
                           torch.tensor(d2, device=device))}


def _compare_hits(got, ref, what, failures):
    """prim equal off ties, t within rtol 1e-5 where prim agrees →
    (share agreeing off ties, ties, max |dt|)."""
    same = got.prim == ref.prim
    both = (got.prim >= 0) & (ref.prim >= 0)
    tie = ~same & both & ((got.t - ref.t).abs() <= 1e-6 * ref.t.abs())
    agree = float((same | tie).float().mean())
    if agree < 0.999:
        failures.append(f"{what}: prim agrees off ties on {agree:.5f}")
    hit = same & both
    tg, tr = got.t[hit], ref.t[hit]
    if not bool(torch.allclose(tg, tr, rtol=1e-5, atol=0.0)):
        failures.append(f"{what}: t differs beyond rtol 1e-5")
    err = float((tg - tr).abs().max()) if tg.numel() else 0.0
    return agree, int(tie.sum()), err


def _compare_uv(got, ref, what, failures):
    """u and v where prim agrees on a hit (B1, B4, B6, B7 and the AOV
    trace): both within 1e-3 (of their [0, 1] range) on >= 99.9% of those
    rays. A barycentric is a difference
    of products, contracted differently by the kernel and by PyTorch, and a
    near-degenerate triangle magnifies that: on the bridge's camera rays
    0.3% of B7's closest hits differ by more than rtol 1e-4, atol 1e-5, up
    to 1.1e-3 → (the share within 1e-3, max |du|, |dv|)."""
    hit = (got.prim == ref.prim) & (ref.prim >= 0)
    if not bool(hit.any()):
        return 1.0, 0.0
    du = (got.u[hit] - ref.u[hit]).abs()
    dv = (got.v[hit] - ref.v[hit]).abs()
    share = float(((du <= 1e-3) & (dv <= 1e-3)).float().mean())
    if share < 0.999:
        failures.append(f"{what}: u, v within 1e-3 on {share:.5f} of the "
                        "hits")
    return share, float(torch.maximum(du, dv).max())


def _compare_any_hits(got, ref, what, failures):
    """Any-hit hits, whose t is t_min: occlusion and prim equal on >=
    99.9% of rays (no tie is told apart by t), u and v as _compare_uv →
    (share with equal occlusion, share with equal prim, u/v share, max
    |du|, |dv|)."""
    occluded = float(((got.prim >= 0) == (ref.prim >= 0)).float().mean())
    agree = float((got.prim == ref.prim).float().mean())
    if occluded < 0.999:
        failures.append(f"{what}: occlusion agrees on {occluded:.5f}")
    if agree < 0.999:
        failures.append(f"{what}: prim agrees on {agree:.5f}")
    return (occluded, agree, *_compare_uv(got, ref, what, failures))


def _prim_distances(hit, tris, origin, direction):
    """An any-hit Hit, whose t is t_min on a hit, with t replaced by the
    distance along each ray to the plane of the triangle it reports (inf on
    a miss): _compare_hits then holds its prim off ties, a tie being two
    triangles the ray meets at one distance."""
    from bifrost3d_tpu_torch.geometry.traverse import Hit, moller_trumbore
    v = tris[hit.prim.clamp_min(0).long()]
    t, _, _, _ = moller_trumbore(origin, direction, v[:, 0], v[:, 1], v[:, 2])
    return Hit(t=torch.where(hit.prim >= 0, t, float("inf")), prim=hit.prim,
               u=hit.u, v=hit.v)


def bvh_kernel_phase(device, dense_soup) -> dict:
    from bifrost3d_tpu_torch.apps.scenes import torus_grid_mesh
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense

    mesh = torus_grid_mesh()
    tris = torch.tensor(mesh.positions[mesh.indices], device=device)
    t0 = time.perf_counter()
    packed = hier.pack_hierarchical(tris)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    n_tris, n_nodes = packed.n_tris, int(packed.node_boxes.shape[0])
    tree_bytes = 64 * int(packed.child_records.shape[0]) + 52 * n_tris
    print(f"kernel/bvh: packed {n_tris} triangles, {n_nodes} nodes "
          f"({tree_bytes / 2**20:.1f} MiB) in {pack_s:.2f} s with the native "
          f"builder", flush=True)

    results, failures = {}, []
    inf = float("inf")
    occupancy = (hier.blocks_per_sm(False), hier.blocks_per_sm(True))
    print(f"kernel/bvh: persistent grid of {occupancy[0]} (any-hit "
          f"{occupancy[1]}) blocks of {hier._THREADS} threads per SM x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} "
          f"SMs", flush=True)
    for name, (o, d) in _torus_rays(device).items():
        stats = {}
        ref = hier.hierarchical_intersect_reference(packed, o, d, 1e-4, inf,
                                                    stats=stats)
        got = hier.hierarchical_intersect_cuda(packed, o, d, 1e-4, inf)
        agree, ties, err = _compare_hits(got, ref, f"bvh/{name}", failures)
        srt = hier.hierarchical_intersect_sorted(packed, o, d, 1e-4, inf)
        s_agree, s_ties, s_err = _compare_hits(srt, ref, f"bvh/{name}/sorted",
                                               failures)
        uv = [_compare_uv(hit, ref, f"bvh/{name}{suffix}", failures)
              for hit, suffix in ((got, ""), (srt, "/sorted"))]
        uv_agree, uv_err = min(u[0] for u in uv), max(u[1] for u in uv)
        # Occlusion within a finite segment, and the live prefix.
        t_max = torch.where(ref.prim >= 0, ref.t * 1.5, 20.0)
        t_max[::2] *= 0.5
        occ_ref = hier.hierarchical_intersect_reference(
            packed, o, d, 1e-4, t_max, any_hit=True).prim >= 0
        occ = hier.hierarchical_intersect_cuda(packed, o, d, 1e-4, t_max,
                                               any_hit=True).prim >= 0
        occ_agree = float((occ == occ_ref).float().mean())
        if occ_agree < 0.999:
            failures.append(f"bvh/{name}: occlusion agrees on {occ_agree:.5f}")
        # The live prefix, as a device int64 (the pool's live sum) and as
        # an int, closest and any-hit.
        live = torch.tensor(R // 3, device=device)
        part = hier.hierarchical_intersect_cuda(packed, o, d, 1e-4, inf,
                                                live_count=live)
        occ_part = hier.hierarchical_intersect_cuda(
            packed, o, d, 1e-4, t_max, any_hit=True, live_count=R // 3)
        torch.cuda.synchronize()
        if not bool((part.prim[R // 3:] == -1).all()) or not bool(
                torch.equal(part.prim[:R // 3], got.prim[:R // 3])):
            failures.append(f"bvh/{name}: the live prefix is not honoured")
        if not bool((occ_part.prim[R // 3:] == -1).all()) or not bool(
                torch.equal(occ_part.prim[:R // 3] >= 0, occ[:R // 3])):
            failures.append(f"bvh/{name}: the any-hit live prefix is not "
                            "honoured")
        hits = float((ref.prim >= 0).float().mean())
        box_tests, tri_tests = int(stats["box_tests"]), int(stats["tri_tests"])
        rows_read = 1 + int(stats["unique_internal"])
        tris_read = int(stats["unique_tris"])
        ms = _median_ms(lambda: hier.hierarchical_intersect_cuda(
            packed, o, d, 1e-4, inf))
        any_ms = _median_ms(lambda: hier.hierarchical_intersect_cuda(
            packed, o, d, 1e-4, t_max, any_hit=True))
        sorted_ms = _median_ms(lambda: hier.hierarchical_intersect_sorted(
            packed, o, d, 1e-4, inf))
        plain_ms = _median_ms(lambda: hier.hierarchical_intersect_reference(
            packed, o, d, 1e-4, inf), repeats=2, warmup=1)
        # Rays in (24 B) and hits out (16 B); of the tree, only what this
        # ray set's walk reads, each record once: the root's row and the
        # 64-byte child record of every internal node entered, the 48-byte
        # triangles of the leaves entered by at least one ray, and one
        # 4-byte `order` entry per hit. Counts are the plain walk's
        # (left-first: no fewer than a near-first walk needs).
        n_hits = int((ref.prim >= 0).sum())
        results[name] = dict(
            agree=min(agree, s_agree), ties=ties + s_ties,
            max_abs_err=max(err, s_err), occlusion_agree=occ_agree, hits=hits,
            uv_agree=uv_agree, uv_err=uv_err,
            box_tests=box_tests, tri_tests=tri_tests, steps=stats["steps"],
            ms=ms, any_ms=any_ms, sorted_ms=sorted_ms, plain_ms=plain_ms,
            blocks_per_sm=occupancy[0],
            rows_read=rows_read, tris_read=tris_read,
            **roofline(40 * R + 64 * rows_read + 48 * tris_read + 4 * n_hits,
                       BOX_FLOPS * box_tests + MT_FLOPS * tri_tests))
        print(f"kernel/bvh/{name}: {R} rays x {n_tris} tris | hit share "
              f"{hits:.3f} | prim agrees off ties >= {min(agree, s_agree):.5f} "
              f"({ties + s_ties} ties), max |dt| {max(err, s_err):.3g}, "
              f"u, v within 1e-3 on {uv_agree:.5f} of hits (max |du|, |dv| "
              f"{uv_err:.3g}), occlusion agrees {occ_agree:.5f} | plain walk: "
              f"{stats['steps']} steps, {box_tests / R:.1f} box and "
              f"{tri_tests / R:.1f} triangle tests per ray, {rows_read} "
              f"distinct child records and {tris_read} distinct triangles "
              f"read | "
              f"closest "
              f"{ms:.4f} ms, any-hit {any_ms:.4f} ms, sorted wrapper "
              f"{sorted_ms:.4f} ms (median of 20), plain {plain_ms:.1f} ms "
              f"(median of 2) | bound {results[name]['bound_ms']:.5f} ms by "
              f"{results[name]['bound_by']}", flush=True)

    # The BVH kernel against the dense kernel on a soup both can take.
    comp, n = dense.pack_triangles(dense_soup)
    small = hier.pack_hierarchical(dense_soup)
    o, d, _ = _rays(np.random.default_rng(5), "sphere", device)
    ref = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, inf)
    got = hier.hierarchical_intersect_cuda(small, o, d, 1e-4, inf)
    torch.cuda.synchronize()
    agree, ties, err = _compare_hits(got, ref, "bvh vs dense", failures)
    print(f"kernel/bvh vs dense: {R} rays x {n} tris | prim agrees off ties "
          f"{agree:.5f} ({ties} ties), max |dt| {err:.3g}", flush=True)
    check(not failures, "; ".join(failures))
    return results


def smallpt_path_phase(device) -> None:
    from bifrost3d_tpu_torch.apps import smallpt_app
    from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt
    from bifrost3d_tpu_torch.io.image import save_image

    w, h, n = SMALLPT_W, SMALLPT_H, ACCUMULATIONS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # Main path A, driven with every count at 0.
    _reset_counts()
    img = smallpt_app.render_progressive(w, h, n, quiet=True, device=device)
    launches = spt.launch_count
    check(launches == n, f"main path A launched the SmallPT kernel "
          f"{launches} times for {n} frames")
    check(img.shape == (h, w, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "smallpt image is not finite")
    mean = float(img.mean())
    check(mean > 0.1, f"smallpt image mean {mean} is not lit")
    # Left wall red, right wall blue (the scene's own sanity check).
    band, edge = img[h // 3:2 * h // 3], max(w // 25, 1)
    left, right = band[:, :edge], band[:, -edge:]
    check(float(left[..., 0].mean()) > 2 * float(left[..., 2].mean())
          and float(right[..., 2].mean()) > 2 * float(right[..., 0].mean()),
          "smallpt wall colours are wrong")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    png = os.path.join(REPO, "build", f"smallpt_{w}x{h}.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    save_image(png, img.flip(0))
    check(os.path.getsize(png) > 0, "PNG not written")

    # A render after the first (the scene and the kernel's tables are then
    # on the card) under torch.profiler, with torch's sync debug mode
    # raising on a synchronising torch op.
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with record_function("chip_smoke_smallpt"):
                smallpt_app.render_progressive(w, h, n, quiet=True,
                                               device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    events = prof.events()
    window = next(e for e in events if e.name == "chip_smoke_smallpt")
    inside = [e for e in events if window.time_range.start
              <= e.time_range.start <= window.time_range.end]
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = dict(
        launches=sum("LaunchKernel" in e.name for e in inside),
        memsets=sum("Memset" in e.name and e.device_type
                    != torch.autograd.DeviceType.CUDA for e in inside),
        syncs=sum("Synchronize" in e.name for e in inside),
        copies=sum("Memcpy" in e.name for e in inside),
        smallpt=sum("smallpt_kernel" in e.name for e in on_card),
        other=sum("smallpt_kernel" not in e.name and "Memset" not in e.name
                  for e in on_card))
    check(counts["smallpt"] == n, f"the profiled render ran {counts['smallpt']} "
          f"SmallPT kernels for {n} frames")
    check(counts["launches"] <= n + 1 and counts["memsets"] <= n,
          f"the profiled render made {counts['launches']} launches and "
          f"{counts['memsets']} memsets for {n} frames (one each a frame, "
          "one fill of the buffer)")
    check(counts["copies"] == 0, f"the profiled render copied "
          f"{counts['copies']} times between host and card")
    check(counts["syncs"] <= 1, f"the profiled render synchronised "
          f"{counts['syncs']} times (once, at its return)")
    print(f"smallpt: {w}x{h} x{n} through smallpt_app.render_progressive | "
          f"SmallPT-kernel launches {launches} | mean {mean:.4f} | peak "
          f"{peak_gib:.3f} GiB | {os.path.relpath(png, REPO)}", flush=True)
    print(f"smallpt/frame: torch.profiler over a render of {n} frames after "
          f"the first: {counts['smallpt']} SmallPT kernels, "
          f"{counts['launches']} kernel-launch calls, {counts['memsets']} "
          f"memsets, {counts['other']} other device activities (the buffer's "
          f"fill), {counts['syncs']} host synchronise (the return's), "
          f"{counts['copies']} host-device copies; sync debug mode raised "
          f"nothing", flush=True)


def torus_path_phase(device) -> dict:
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    res = TORUS_RES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene, cam = TEST_SCENES["torus_grid"](device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_tris = int(scene.tri_verts.shape[0])
    check(n_tris == TORUS_TRIS, f"the torus grid has {n_tris} triangles")
    check(scene.tri_components is None and scene.tri_clustered is not None,
          "a scene over 65,536 triangles must carry the BVH packing only")
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    check(settings.sort_rays_every == 1, "a BVH scene sorts its pool")
    path = pt.explain_render_path(scene, settings)
    check(path.startswith("wavefront [BVH trace"), path)
    print(f"torus_grid: {n_tris} triangles built in {build_s:.2f} s | "
          f"{path}", flush=True)

    # Main path B, driven with every count at 0.
    _reset_counts()
    img = pt.render_sample_fast(scene, cam, res, res, 0, settings)
    torch.cuda.synchronize()
    launches, dense_launches = hier.launch_count, dense.launch_count
    check(launches > 0, "main path B launched no BVH trace kernel")
    check(dense_launches == 0, f"main path B launched the dense kernel "
          f"{dense_launches} times")
    check(img.shape == (res, res, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "torus image is not finite")
    mean = float(img.mean())
    check(mean > 0.005, f"torus image mean {mean} is not lit")

    # Frames with the pool sort (the scene's settings) and, in turns, without
    # it (no sort, no live prefix): the same paths, lanes in another order.
    unsorted = settings._replace(sort_rays_every=0)
    frame_ms, rates, unsorted_ms, steps = [], [], [], 0
    for acc in (1, 2, 3):
        for which in (settings, unsorted):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, rays, iters = pt.render_pixels_pooled(
                scene, cam, res, res, acc, which, with_iters=True)
            rays = int(rays)   # synchronises
            dt = time.perf_counter() - t0
            if which is settings:
                steps = iters
                frame_ms.append(dt * 1e3)
                rates.append(rays / dt)
            else:
                unsorted_ms.append(dt * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # The same small frame with the kernel and with its plain version.
    small = 128
    kern = pt.render_sample_fast(scene, cam, small, small, 1, settings)
    with mock.patch.object(hier, "hierarchical_intersect",
                           hier.hierarchical_intersect_reference):
        plain = pt.render_sample_fast(scene, cam, small, small, 1, settings)
    flips, _, _ = _gate(kern, plain, "torus_grid: kernel vs plain trace")

    png = os.path.join(REPO, "build", f"torus_grid_{res}.png")
    save_image(png, process(img, CameraEffectsSettings.preset()._replace(
        film_grain=0.0)))
    out = dict(launches=launches, steps=steps, mean=mean, flips=flips,
               frame_ms=statistics.median(frame_ms),
               rays_per_s=statistics.median(rates),
               unsorted_frame_ms=statistics.median(unsorted_ms),
               build_s=build_s, peak_gib=peak_gib)
    print(f"torus_grid: {res}x{res} {BOUNCES} bounces through "
          f"render_sample_fast | BVH-kernel launches {launches}, dense-kernel "
          f"launches {dense_launches} | {steps} wavefront steps | mean "
          f"{mean:.4f} | frame {out['frame_ms']:.1f} ms, "
          f"{out['rays_per_s'] / 1e6:.2f} M rays/s (median of 3; without the "
          f"pool sort {out['unsorted_frame_ms']:.1f} ms) | gate vs "
          f"plain trace at {small}x{small}: {flips:.4f} flips | peak "
          f"{peak_gib:.3f} GiB | {os.path.relpath(png, REPO)}", flush=True)
    return out


def _bridge_rays(scene, cam, device):
    """The two ray sets of the cluster kernels' check on the bridge scene:
    its 65,536 camera rays at 256 x 256 in raster order (a block of 256 is
    one image row, a group of 32 a row segment), and 65,536 seeded rays
    with origins spread through the scene's box and directions over the
    sphere."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    args = mega.megakernel_inputs(scene, cam, 256, 256, 0,
                                  pt.RenderSettings(max_bounce_count=1))
    rng = np.random.default_rng(7)
    o2 = rng.uniform((-2.0, -0.5, -2.0), (2.0, 1.0, 2.0),
                     size=(R, 3)).astype(np.float32)
    d2 = rng.normal(size=(R, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return {"coherent": (args[6].contiguous(), args[7].contiguous()),
            "incoherent": (torch.tensor(o2, device=device),
                           torch.tensor(d2, device=device))}


def cluster_kernel_phase(device, dense_soup, device_times) -> dict:
    """The cluster scan and the resident-cluster walk against their plain
    versions, and all four trace kernels side by side; the scan's device
    times are ``device_times`` (trace_device_phase's)."""
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.geometry.bvh import build_soup_bvh

    cases = [(soup_name, tris, bvh, name, o, d)
             for soup_name, tris, bvh, ray_sets in _scan_cases(
                 device, {"sphere": dense_soup})
             for name, (o, d) in ray_sets.items()]
    results, failures, packings = {}, [], {}
    inf = float("inf")
    for soup_name, tris, bvh, ray_name, o, d in cases:
        if soup_name not in packings:
            check(vmem.fits_vmem(int(tris.shape[0])),
                  f"the {soup_name} soup does not fit the resident table")
            bvh = bvh if bvh is not None else build_soup_bvh(tris)
            packings[soup_name] = (
                clustered.pack_clustered(tris, bvh), vmem.pack_vmem(tris, bvh),
                hier.pack_hierarchical(tris, bvh), dense.pack_triangles(tris))
        scan, walk, tree, (comp, n) = packings[soup_name]
        what = f"{soup_name}/{ray_name}"
        n_clusters = int(scan.cluster_boxes.shape[0])

        by_dense = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, inf)
        by_tree = hier.hierarchical_intersect_cuda(tree, o, d, 1e-4, inf)
        scan_stats, walk_stats = {}, {}
        scan_ref = clustered.clustered_intersect_reference(
            scan, o, d, 1e-4, inf)
        # The plain model of the kernel's cull: the same hits, its work.
        model = clustered.clustered_intersect_reference(
            scan, o, d, 1e-4, inf, stats=scan_stats, culled=True)
        if not all(torch.equal(x, y) for x, y in zip(model, scan_ref)):
            failures.append(f"clustered/{what}: the cull's plain model is "
                            "not the scan's hits")
        by_scan = clustered.clustered_intersect_cuda(scan, o, d, 1e-4, inf)
        walk_ref = vmem.vmem_intersect_reference(walk, o, d, 1e-4, inf,
                                                 stats=walk_stats)
        # The plain model of the walk's leaf cull: the same hits, its work.
        cull_stats = {}
        t0 = time.perf_counter()
        walk_model = vmem.vmem_intersect_reference(
            walk, o, d, 1e-4, inf, stats=cull_stats, culled=True)
        model_s = time.perf_counter() - t0
        if not all(torch.equal(x, y) for x, y in zip(walk_model, walk_ref)):
            failures.append(f"vmem/{what}: the cull's plain model is not the "
                            "plain walk's hits")
        by_walk = vmem.vmem_intersect_cuda(walk, o, d, 1e-4, inf)
        torch.cuda.synchronize()
        out = {}
        for key, got, ref in (("clustered", by_scan, scan_ref),
                              ("vmem", by_walk, walk_ref)):
            agree, ties, err = _compare_hits(got, ref, f"{key}/{what}",
                                             failures)
            for other, name in ((by_dense, "dense"), (by_tree, "bvh")):
                a2, t2, _ = _compare_hits(got, other,
                                          f"{key} vs {name}/{what}", failures)
                agree, ties = min(agree, a2), ties + t2
            out[key] = dict(agree=agree, ties=ties, max_abs_err=err)
        uv_agree, uv_err = _compare_uv(by_walk, walk_ref, f"vmem/{what}",
                                       failures)
        scan_uv = _compare_uv(by_scan, scan_ref, f"clustered/{what}",
                              failures)
        out["clustered"].update(uv_agree=scan_uv[0], uv_err=scan_uv[1])

        # The walk within a finite segment (closest hit and occlusion), and
        # its live prefix as an int, an int32 and an int64 tensor.
        t_max = _bounded(walk_ref)
        bounded_ref = vmem.vmem_intersect_reference(walk, o, d, 1e-4, t_max)
        bounded = vmem.vmem_intersect_cuda(walk, o, d, 1e-4, t_max)
        a2, t2, e2 = _compare_hits(bounded, bounded_ref,
                                   f"vmem/{what}/bounded", failures)
        out["vmem"].update(agree=min(out["vmem"]["agree"], a2),
                           ties=out["vmem"]["ties"] + t2,
                           max_abs_err=max(out["vmem"]["max_abs_err"], e2))
        # Any-hit: the leaf's nearest hit, then the ray frozen, as the
        # plain version; its prim also under the closest-hit gate, each hit
        # at the distance of the triangle it names.
        any_got = vmem.vmem_intersect_cuda(walk, o, d, 1e-4, t_max,
                                           any_hit=True)
        any_ref = vmem.vmem_intersect_reference(walk, o, d, 1e-4, t_max,
                                                any_hit=True)
        occ_agree, any_agree, any_uv, any_err = _compare_any_hits(
            any_got, any_ref, f"vmem/{what}/any-hit", failures)
        any_gate, any_ties, _ = _compare_hits(
            _prim_distances(any_got, tris, o, d),
            _prim_distances(any_ref, tris, o, d),
            f"vmem/{what}/any-hit (closest-hit gate)", failures)
        live = R // 3 + 5       # inside a group, which is traced whole
        covered = -(-live // vmem.GROUP_R) * vmem.GROUP_R
        parts = [vmem.vmem_intersect_cuda(walk, o, d, 1e-4, inf,
                                          live_count=count)
                 for count in (live, torch.tensor(live, device=device),
                               torch.tensor([live], dtype=torch.int32,
                                            device=device))]
        torch.cuda.synchronize()
        for part in parts:
            if not bool((part.prim[covered:] == -1).all()) or not all(
                    torch.equal(x[:covered], y[:covered])
                    for x, y in zip(part, by_walk)):
                failures.append(f"vmem/{what}: the live prefix is not "
                                "honoured")

        times = dict(
            dense=_median_ms(lambda: dense.dense_intersect_cuda(
                comp, n, o, d, 1e-4, inf), repeats=5, warmup=1),
            bvh=_median_ms(lambda: hier.hierarchical_intersect_cuda(
                tree, o, d, 1e-4, inf)),
            clustered=_median_ms(lambda: clustered.clustered_intersect_cuda(
                scan, o, d, 1e-4, inf), repeats=10, warmup=2),
            vmem=_median_ms(lambda: vmem.vmem_intersect_cuda(
                walk, o, d, 1e-4, inf), repeats=10, warmup=2),
            vmem_any=_median_ms(lambda: vmem.vmem_intersect_cuda(
                walk, o, d, 1e-4, t_max, any_hit=True), repeats=10, warmup=2))
        plain = dict(
            clustered=_median_ms(
                lambda: clustered.clustered_intersect_reference(
                    scan, o, d, 1e-4, inf), repeats=2, warmup=0),
            vmem=_median_ms(lambda: vmem.vmem_intersect_reference(
                walk, o, d, 1e-4, inf), repeats=2, warmup=0))
        n_hits = int((scan_ref.prim >= 0).sum())
        # The TPU design: rays in (32 B), hits out (16 B), every cluster's
        # box (32 B), each fetched cluster's 512 x 9 floats once, one
        # `order` entry per hit; a box test per ray and cluster, and per
        # (block, cluster) fetch 256 x 512 triangle tests.
        tpu = roofline(48 * R + 32 * n_clusters + 4 * n_hits
                       + 36 * clustered.CLUSTER_T * scan_stats["clusters_read"],
                       BOX_FLOPS * R * n_clusters + MT_FLOPS * clustered.BLOCK_R
                       * clustered.CLUSTER_T * scan_stats["fetches"])
        # This kernel's work: origin and direction in (24 B), hits out
        # (16 B), the boxes (32 B a cluster, unpadded and padded), each
        # fetched cluster's 512 records (48 B) and 16 chunk boxes once, one
        # `order` entry per hit; the block rule's box test per ray and
        # cluster, and per ray of a fetching block the padded cluster box,
        # the chunk boxes of an entered cluster and the triangles of an
        # entered chunk.
        own = roofline(40 * R + 64 * n_clusters + 4 * n_hits
                       + (48 * clustered.CLUSTER_T + 32 * 16)
                       * scan_stats["clusters_read"],
                       BOX_FLOPS * (R * n_clusters + scan_stats["cluster_tests"]
                                    + scan_stats["box_tests"])
                       + MT_FLOPS * scan_stats["tri_tests"])
        out["clustered"].update(
            ms=times["clustered"], plain_ms=plain["clustered"],
            device_ms=device_times[f"clustered/{what}"],
            fetches=scan_stats["fetches"],
            clusters_read=scan_stats["clusters_read"],
            cluster_tests=scan_stats["cluster_tests"] / R,
            chunk_box_tests=scan_stats["box_tests"] / R,
            tri_tests=scan_stats["tri_tests"] / R,
            bound_full_ms=tpu["bound_ms"], bound_full_by=tpu["bound_by"],
            **own)
        # The walk's TPU design: rays in, hits out, each node record read
        # (32 B box and 4 B meta) and each entered cluster's 512 x 9 floats
        # once; 32 box tests per group probe, 32 x 512 triangle tests per
        # leaf entered.
        tpu = roofline(48 * R + 36 * walk_stats["nodes_read"] + 4 * n_hits
                       + 36 * vmem.CLUSTER_T * walk_stats["clusters_read"],
                       BOX_FLOPS * vmem.GROUP_R * walk_stats["probes"]
                       + MT_FLOPS * vmem.GROUP_R * vmem.CLUSTER_T
                       * walk_stats["leaf_tests"])
        # This kernel's work: origin and direction in (24 B), hits out
        # (16 B), each node record read once, each entered cluster's padded
        # box and 16 chunk boxes (32 B each) and the records of the chunks
        # entered (48 B each) once, one `order` entry per hit; 32 box tests
        # per group probe, then per ray the padded cluster boxes, the chunk
        # boxes and the triangles the cull tests.
        own = roofline(40 * R + 36 * walk_stats["nodes_read"] + 4 * n_hits
                       + 32 * 17 * walk_stats["clusters_read"]
                       + 48 * dense.CHUNK * cull_stats["chunks_read"],
                       BOX_FLOPS * (vmem.GROUP_R * walk_stats["probes"]
                                    + cull_stats["cluster_tests"]
                                    + cull_stats["box_tests"])
                       + MT_FLOPS * cull_stats["tri_tests"])
        out["vmem"].update(
            ms=times["vmem"], any_ms=times["vmem_any"],
            plain_ms=plain["vmem"], occlusion_agree=occ_agree,
            any_prim_agree=any_agree, any_uv_agree=any_uv, any_uv_err=any_err,
            any_gate_agree=any_gate, any_ties=any_ties, uv_agree=uv_agree,
            uv_err=uv_err,
            device_ms=device_times[f"vmem/{what}"],
            any_device_ms=device_times[f"vmem_any/{what}"],
            probes=walk_stats["probes"], leaf_tests=walk_stats["leaf_tests"],
            clusters_read=walk_stats["clusters_read"],
            cluster_tests=cull_stats["cluster_tests"] / R,
            chunk_box_tests=cull_stats["box_tests"] / R,
            tri_tests=cull_stats["tri_tests"] / R,
            chunks_read=cull_stats["chunks_read"], model_s=model_s,
            bound_full_ms=tpu["bound_ms"], bound_full_by=tpu["bound_by"],
            **own)
        out["dense_ms"], out["bvh_ms"] = times["dense"], times["bvh"]
        results[what] = out
        n_blocks = -(-R // clustered.BLOCK_R)
        n_groups = -(-R // vmem.GROUP_R)
        for key in ("clustered", "vmem"):
            k = out[key]
            work = (f"{k['fetches'] / n_blocks:.1f} of {n_clusters} clusters "
                    f"fetched per block of {clustered.BLOCK_R}, u, v agree "
                    f"on {k['uv_agree']:.5f} of hits (max |du|, |dv| "
                    f"{k['uv_err']:.3g})"
                    if key == "clustered" else
                    f"{k['probes'] / n_groups:.1f} probes and "
                    f"{k['leaf_tests'] / n_groups:.2f} leaves per group of "
                    f"{vmem.GROUP_R}, {k['chunks_read']} chunks read "
                    f"(culled plain model {k['model_s']:.1f} s), "
                    f"u, v agree on {k['uv_agree']:.5f} of hits (max "
                    f"|du|, |dv| {k['uv_err']:.3g}), any-hit occlusion "
                    f"agrees {occ_agree:.5f}, prim {k['any_prim_agree']:.5f}"
                    f" (off ties {k['any_gate_agree']:.5f}, "
                    f"{k['any_ties']} ties)"
                    f", u, v {k['any_uv_agree']:.5f} (max "
                    f"{k['any_uv_err']:.3g}), any-hit call "
                    f"{k['any_ms']:.4f} ms, device "
                    f"{k['any_device_ms']:.4f} ms")
            work += (f"; per ray {k['cluster_tests']:.1f} padded cluster "
                     f"boxes, {k['chunk_box_tests']:.1f} chunk boxes and "
                     f"{k['tri_tests']:.1f} triangles tested; device "
                     f"{k['device_ms']:.4f} ms (torch.profiler, mean of "
                     f"10); TPU-design bound {k['bound_full_ms']:.5f} ms by "
                     f"{k['bound_full_by']}")
            print(f"kernel/{key}/{what}: {R} rays x {n} tris | prim agrees off "
                  f"ties >= {k['agree']:.5f} with the plain version, the "
                  f"dense and the BVH kernel ({k['ties']} ties), max |dt| "
                  f"{k['max_abs_err']:.3g} | {work} | kernel {k['ms']:.4f} ms "
                  f"(median of 10), plain {k['plain_ms']:.1f} ms (median of "
                  f"2) | dense kernel {out['dense_ms']:.4f} ms, BVH kernel "
                  f"{out['bvh_ms']:.4f} ms on the same rays | bound of its "
                  f"own work {k['bound_ms']:.5f} ms by {k['bound_by']}",
                  flush=True)
    check(not failures, "; ".join(failures))
    return results


def _gate_tiled_scene(name, scene, cam, res, settings, device):
    """One frame of a megakernel scene (the kernel's lanes in pixel tiles
    on the BVH branch, its image in raster order): the kernel against its
    plain version on the torch lanes in raster order (KERNEL_FLIPS,
    KERNEL_MEAN) and against the pooled wavefront (3%, 2%), ray counts
    within 2% → (results, the kernel's arguments, the image)."""
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    _expect_megakernel(scene, settings, name)
    args, lanes, got_rays = _kernel_frame(scene, cam, res, 1, settings)
    _, ref, ref_rays = _plain_frame(scene, cam, res, 1, settings)
    torch.cuda.synchronize()
    flips, max_err, mean_rel = _gate(lanes, ref, f"{name}: kernel vs plain",
                                     KERNEL_FLIPS, KERNEL_MEAN)
    rays, plain_rays = float(got_rays.sum()), float(ref_rays.sum())
    img = lanes.reshape(res, res, 3)
    pooled, pooled_rays = pt.render_sample_pooled_counted(
        scene, cam, res, res, 1, settings)
    wf_flips, _, _ = _gate(img, pooled, f"{name}: kernel vs wavefront")
    pooled_rays = int(pooled_rays)
    for other, whose in ((plain_rays, "plain version"),
                         (pooled_rays, "wavefront")):
        check(abs(rays - other) <= 0.02 * other,
              f"{name}: {rays} rays vs the {whose}'s {other}")
    out = dict(res=res, n_tris=int(scene.tri_verts.shape[0]), flips=flips,
               max_abs_err=max_err, mean_rel=mean_rel,
               wavefront_flips=wf_flips, rays=rays,
               wavefront_rays=pooled_rays, mean=float(img.mean()),
               pooled=pooled)
    return out, args, img


def megakernel_hier_phase(device) -> dict:
    """The megakernel's BVH branch against its plain version and the pooled
    wavefront; the bridge scene at 512 x 512 in pixel tiles against its
    plain version."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    results = {}
    tile = mega.HIER_PIXEL_TILE
    for name in HIER_SCENES:
        res = SMALL_RES
        scene, cam = TEST_SCENES[name](device=device)
        settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
        out, args, _ = _gate_tiled_scene(name, scene, cam, res, settings,
                                         device)
        check(args[-1].hier, f"{name}: not packed for the BVH branch")
        print(f"megakernel/hier/{name}: {res}x{res} {out['n_tris']} tris, "
              f"tree depth {args[0].max_depth} | vs plain "
              f"{out['flips']:.5f} flips, max |d| {out['max_abs_err']:.3g}, "
              f"means {out['mean_rel']:.2e} apart | vs wavefront "
              f"{out['wavefront_flips']:.4f} flips | rays {out['rays']:.0f} "
              f"vs {out['wavefront_rays']} | mean {out['mean']:.4f}",
              flush=True)
        results[name] = out

    # The bridge at the main path's size, in the pixel tiles the BVH branch
    # renders in, against its plain version in raster order. Its kHier
    # instantiation without kExtras runs in no cell, so it is timed here.
    res = RES
    scene, cam = TEST_SCENES[BRIDGE_SCENE](device=device)
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    args, img, got_rays = _kernel_frame(scene, cam, res, 1, settings)
    cfg = args[-1]
    check(args[6].tile == tile, "the BVH branch renders in pixel tiles")
    ms = _median_ms(lambda: mega.mesh_megakernel_cuda(*args), repeats=10,
                    warmup=2)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ref, _ = _plain_frame(scene, cam, res, 1, settings, stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    flips, max_err, _ = _gate(img, ref, f"{BRIDGE_SCENE} {res}: kernel vs plain",
                              KERNEL_FLIPS, KERNEL_MEAN)
    rays = float(got_rays.sum())
    tree = args[0]
    n_records, n_tris = int(tree.child_records.shape[0]), tree.n_tris
    # Per pixel 16 B out; of the child records (64 B, two box tests each)
    # and the attribute table no more than each record once (a frame's
    # walks touch most of them); the plain walks' box and triangle tests and
    # the shading of every iteration that shaded a hit (shade_ops).
    out = results[BRIDGE_SCENE]
    out.update(
        ms=ms, plain_ms=plain_ms, max_abs_err=max(max_err, out["max_abs_err"]),
        **roofline(16 * res * res
                   + 64 * min(n_records, stats["box_tests"] // 2)
                   + (48 + 4 * mega.ATTR_ROWS) * min(n_tris, stats["tri_tests"]),
                   BOX_FLOPS * stats["box_tests"]
                   + MT_FLOPS * stats["tri_tests"]
                   + shade_ops(cfg.ris_count, cfg.has_coat, cfg.extras)
                   * stats["shaded"]))
    print(f"megakernel/hier/{BRIDGE_SCENE}: {res}x{res} with {tile[0]}x"
          f"{tile[1]} pixel tiles | kernel {ms:.3f} ms (median of 10), plain "
          f"{plain_ms:.0f} ms (one run) | vs plain {flips:.5f} flips, max "
          f"|d| {max_err:.3g} | {rays:.0f} rays, "
          f"{stats['box_tests'] / rays:.1f} box and "
          f"{stats['tri_tests'] / rays:.1f} triangle tests per ray (plain "
          f"walk) | bound {out['bound_ms']:.5f} ms by {out['bound_by']}",
          flush=True)
    return results


WALK_SCENES = (BRIDGE_SCENE, "hier_bridge_15k_env", "torus_grid_28")


def _walk_rays(scene, cam, device) -> dict:
    """The 512² frame's camera rays (the plain version's lanes, 8 x 4
    tiles) and as many seeded rays from inside the scene's box in uniform
    directions."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    lanes = mega.megakernel_inputs(scene, cam, RES, RES, 1,
                                   pt.RenderSettings(max_bounce_count=BOUNCES),
                                   mega.HIER_PIXEL_TILE)
    lo = scene.tri_verts.reshape(-1, 3).amin(0).cpu().numpy()
    hi = scene.tri_verts.reshape(-1, 3).amax(0).cpu().numpy()
    rng = np.random.default_rng(29)
    n = RES * RES
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"camera": (lanes[6], lanes[7]),
            "incoherent": (torch.tensor(o, device=device),
                           torch.tensor(d, device=device))}


def hier_walk_phase(device) -> None:
    """The BVH branch's walk as the megakernel's library builds it
    (megakernel_hier_trace_probe) against the BVH trace kernel, which walks
    the same child records in its own library, on the three main-path BVH
    scenes' trees with their 512² camera rays and seeded incoherent rays:
    t, prim, u and v bit for bit, closest hit and unbounded any-hit (the
    first hit in walk order). Then both walks' times on the bridge's
    rays."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega

    inf = float("inf")
    for name in WALK_SCENES:
        scene, cam = TEST_SCENES[name](device=device)
        tree = mega._pack_scene(scene)["tri"]
        rays = _walk_rays(scene, cam, device)
        times = {}
        for kind, (o, d) in rays.items():
            for any_hit in (False, True):
                query = f"{kind}{'/any' if any_hit else ''}"
                ref = hier.hierarchical_intersect_cuda(tree, o, d, 1e-4, inf,
                                                       any_hit=any_hit)
                check(float((ref.prim >= 0).float().mean()) > 0.05,
                      f"walk/{name} {query}: the rays miss the tree")
                got = mega.hier_trace_probe(tree, o, d, 1e-4, inf,
                                            any_hit=any_hit)
                for f in ("t", "prim", "u", "v"):
                    check(torch.equal(getattr(got, f).view(torch.int32),
                                      getattr(ref, f).view(torch.int32)),
                          f"walk/{name} {query}: {f} differs from the BVH "
                          "kernel's")
                if name == BRIDGE_SCENE:
                    times[f"{query} probe"] = _median_ms(
                        lambda: mega.hier_trace_probe(tree, o, d, 1e-4, inf,
                                                      any_hit=any_hit))
                    times[f"{query} B4"] = _median_ms(
                        lambda: hier.hierarchical_intersect_cuda(
                            tree, o, d, 1e-4, inf, any_hit=any_hit))
        line = (f"walk/{name}: {int(tree.child_records.shape[0])} child "
                f"records | probe vs BVH kernel on {RES * RES} camera and "
                f"{RES * RES} incoherent rays, closest and any-hit: t, prim, "
                f"u, v bit-equal")
        if name == BRIDGE_SCENE:
            line += (" | walks (medians of 20): " + ", ".join(
                f"{q} {ms:.4f} ms" for q, ms in times.items())
                + f" | clocks.sm, power.draw, power.limit: {smi()}")
        print(line, flush=True)


def hier_path_phase(device) -> int:
    """Main path C: the bridge scene through render_progressive → its
    megakernel launches."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    res = RES
    t0 = time.perf_counter()
    scene, cam = TEST_SCENES[BRIDGE_SCENE](device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_tris = int(scene.tri_verts.shape[0])
    check(n_tris == BRIDGE_TRIS, f"the bridge scene has {n_tris} triangles")
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    _expect_megakernel(scene, settings, BRIDGE_SCENE)
    mega.prewarm_megakernel(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # Main path C, driven with every count at 0.
    _reset_counts()
    hdr = pt.render_progressive(scene, cam, res, res, ACCUMULATIONS, settings)
    torch.cuda.synchronize()
    launches = mega.launch_count
    trace_launches = dense.launch_count + hier.launch_count
    check(launches == ACCUMULATIONS, f"main path C launched the megakernel "
          f"{launches} times for {ACCUMULATIONS} frames")
    check(trace_launches == 0, f"main path C launched a trace kernel "
          f"{trace_launches} times")
    check(hdr.shape == (res, res, 3), f"image shape {tuple(hdr.shape)}")
    check(bool(torch.isfinite(hdr).all()), "bridge image is not finite")
    mean = float(hdr.mean())
    check(mean > 0.02, f"bridge image mean {mean} is not lit")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_eager_mean(BRIDGE_SCENE, scene, cam, res, settings, hdr)
    png = os.path.join(REPO, "build", f"{BRIDGE_SCENE}_{res}.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    save_image(png, process(hdr, CameraEffectsSettings.preset()._replace(
        film_grain=0.0)))

    # One frame against a pooled-wavefront frame of the same accumulation.
    img = pt.render_sample_fast(scene, cam, res, res, 5, settings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pooled, pooled_rays = pt.render_sample_pooled_counted(scene, cam, res, res,
                                                          5, settings)
    pooled_rays = int(pooled_rays)   # synchronises
    pooled_ms = (time.perf_counter() - t0) * 1e3
    flips, _, _ = _gate(img, pooled, f"{BRIDGE_SCENE}: frame vs wavefront")
    print(f"hier_bridge: {BRIDGE_SCENE} {n_tris} triangles built in "
          f"{build_s:.2f} s | {res}x{res} {BOUNCES} bounces x{ACCUMULATIONS} "
          f"through render_progressive | megakernel launches {launches}, "
          f"trace-kernel launches {trace_launches} | mean {mean:.4f}, "
          f"bit-equal to the eager loop's | pooled wavefront frame "
          f"{pooled_ms:.0f} ms, {pooled_rays} rays, gate {flips:.4f} flips | "
          f"peak {peak_gib:.3f} GiB | {os.path.relpath(png, REPO)}",
          flush=True)

    for name in ("hier_bridge_3k", "hier_bridge_15k", "torus_grid_28"):
        scene, cam = TEST_SCENES[name](device=device)
        settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
        _expect_megakernel(scene, settings, name)
        mega.prewarm_megakernel(scene)
        before = mega.launch_count
        trace_before = dense.launch_count + hier.launch_count
        for acc in (0, 1, 2):
            img = pt.render_sample_fast(scene, cam, res, res, acc, settings)
        torch.cuda.synchronize()
        check(mega.launch_count == before + 3
              and dense.launch_count + hier.launch_count == trace_before,
              f"{name}: not one megakernel launch per frame and nothing else")
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.005,
              f"{name}: the frame is not finite and lit")
        print(f"hier_bridge: {name} {int(scene.tri_verts.shape[0])} triangles "
              f"| {res}x{res}, one megakernel launch a frame over 3 frames | "
              f"mean {float(img.mean()):.4f}", flush=True)
    return launches


def packing_path_phase(device, dense_frame) -> dict:
    """One pooled-wavefront frame with ``tri_clustered`` set to the
    cluster-scan packing and one with the resident-cluster packing, each
    driven with every count at 0."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    res = SMALL_RES
    scene, cam = TEST_SCENES["hier_bridge_15k"](device=device)
    out = {}
    for name, module, pack in (
            ("clustered", clustered, clustered.pack_clustered),
            ("vmem", vmem, vmem.pack_vmem)):
        packed = scene._replace(tri_clustered=pack(scene.tri_verts, scene.bvh),
                                tri_components=None)
        settings = pt.settings_for_scene(packed, max_bounce_count=BOUNCES)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pt.render_sample_pooled(packed, cam, res, res, 1, settings)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        launches = module.launch_count
        others = (dense.launch_count + hier.launch_count
                  + (vmem if module is clustered else clustered).launch_count)
        check(launches > 0, f"the {name} packing launched no {name} kernel")
        check(others == 0, f"the {name} packing launched another trace "
              f"kernel {others} times")
        flips, _, _ = _gate(img, dense_frame, f"{name} packing vs dense trace")
        out[name] = dict(launches=launches, frame_ms=frame_ms, flips=flips)
        print(f"packings/{name}: hier_bridge_15k {res}x{res} {BOUNCES} bounces "
              f"pooled | {name}-kernel launches {launches}, other "
              f"trace kernels {others} | frame {frame_ms:.0f} ms (one run) | "
              f"gate vs the dense trace: {flips:.4f} flips", flush=True)
    return out


def pooled_frame_phase(device, packing) -> dict:
    """One pooled-wavefront frame of hier_bridge_15k at 512², 4 bounces, on
    its default dense table (``packing`` "dense": B1), on the cluster-scan
    packing ("clustered": B6) or on the resident-cluster packing ("vmem":
    B7), after a first frame and driven with every count at 0: frame time
    (host clock to a synchronise), the trace kernel's launches and its
    share of the frame's device time (torch.profiler over one more frame);
    a packing's frame against the dense table's of the same accumulation
    (the statistical gate). Run in a process of its own."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from torch.profiler import ProfilerActivity, profile

    scene, cam = TEST_SCENES["hier_bridge_15k"](device=device)
    check(scene.tri_components is not None and scene.tri_clustered is None,
          "hier_bridge_15k no longer takes the dense table by default")
    dense_scene, gate = scene, ""
    if packing == "dense":
        module, kernel, what = dense, "dense_intersect_kernel", "dense table"
    else:
        module, kernel, what, pack = {
            "clustered": (clustered, "clustered_intersect_kernel",
                          "cluster-scan packing", clustered.pack_clustered),
            "vmem": (vmem, "vmem_intersect_kernel", "resident-cluster packing",
                     vmem.pack_vmem)}[packing]
        scene = scene._replace(tri_clustered=pack(scene.tri_verts, scene.bvh),
                               tri_components=None)
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pt.render_sample_pooled(scene, cam, RES, RES, 1, settings)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = module.launch_count
    others = sum(m.launch_count for m in (dense, hier, clustered, vmem)
                 if m is not module)
    check(launches > 0, f"pooled/{packing}: no launch of its trace kernel")
    check(others == 0, f"pooled/{packing}: {others} launches of other trace "
          "kernels")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3,
          f"pooled/{packing}: the frame is not finite and lit")
    if packing != "dense":
        ref = pt.render_sample_pooled(
            dense_scene, cam, RES, RES, 1,
            pt.settings_for_scene(dense_scene, max_bounce_count=BOUNCES))
        flips, _, _ = _gate(img, ref, f"pooled/{packing} vs the dense table")
        gate = f" | gate vs the dense table's frame: {flips:.4f} flips"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pt.render_sample_pooled(scene, cam, RES, RES, 2, settings)
        torch.cuda.synchronize()
    busy_us = trace_us = 0.0
    n_device = n_trace = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_device += 1
        busy_us += e.time_range.elapsed_us()
        if kernel in e.name:
            n_trace += 1
            trace_us += e.time_range.elapsed_us()
    check(n_trace == launches, f"pooled/{packing}: the profiled frame shows "
          f"{n_trace} trace kernels, the counted one {launches} launches")
    print(f"pooled/{packing}: hier_bridge_15k {RES}x{RES} {BOUNCES} bounces "
          f"pooled on its {what} | trace launches {launches}, other trace "
          f"kernels 0 | frame {frame_ms:.0f} ms (one run, after a first "
          f"frame) | next frame (torch.profiler): {n_device} device "
          f"activities, busy {busy_us / 1e3:.1f} ms, the trace kernel "
          f"{trace_us / 1e3:.2f} ms = {trace_us / max(busy_us, 1e-9):.1%} of "
          f"busy time and {trace_us / 1e3 / frame_ms:.1%} of the frame"
          f"{gate}", flush=True)
    return dict(frame_ms=frame_ms, launches=launches, trace_ms=trace_us / 1e3,
                busy_ms=busy_us / 1e3, device_ops=n_device)


# A shader-ball path that holds no file: MaterialScene builds its spheres
# here whatever the machine holds at SHADERBALL_PATH (phase 27 loads a ball).
NO_SHADERBALL = os.path.join(REPO, "build", "no_shaderball", "Shaderball.gltf")


def _extras_scene(name, viewer, device):
    from bifrost3d_tpu_torch.apps import scenes
    builder = scenes.SCENES[name] if viewer else scenes.TEST_SCENES[name]
    with mock.patch.object(scenes, "SHADERBALL_PATH", NO_SHADERBALL):
        return builder(device=device)


def megakernel_extras_phase(device) -> dict:
    """The kExtras instantiations (environment map, textures, cutouts and
    the shadow march) against the plain version and the pooled wavefront,
    on both traces."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    results = {}
    res = SMALL_RES
    for name, viewer in EXTRAS_SCENES:
        t0 = time.perf_counter()
        scene, cam = _extras_scene(name, viewer, device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
        check(mega.megakernel_ineligibility_reasons(scene, settings) == [],
              f"{name}: not eligible")
        out, args, img = _gate_tiled_scene(name, scene, cam, res, settings,
                                           device)
        cfg = args[-1]
        check(cfg.extras, f"{name}: does not take the kExtras instantiation")
        check(out["mean"] > 1e-4, f"{name}: image mean {out['mean']} is not "
              "lit")
        if name == "textured_cornell":
            # tests/test_pallas_mesh.py:118-120: the checker shows.
            row = img[-res // 8].amax(dim=-1)
            check(float(row.max()) > 2.0 * max(float(row.min()), 1e-4),
                  "textured_cornell: the floor's checker does not show")
        results[name] = out
        env = cfg.env_meta
        features = ", ".join(f for f, on in (
            (f"map {env[1]}x{env[0]}, pdf {env[3]}x{env[2]}, pool {env[4]}"
             if env else "", env is not None),
            (f"{len(cfg.tex_meta)} textures", bool(cfg.tex_meta)),
            ("coverage", cfg.any_coverage),
            (f"shadow march {cfg.shadow_steps}", cfg.shadow_steps > 0)) if on)
        print(f"megakernel/{name}: "
              f"{pt.explain_render_path(scene, settings)} | {res}x{res} "
              f"{out['n_tris']} tris, {'BVH' if cfg.hier else 'dense'} "
              f"trace, {features} (scene in {build_s:.2f} s) | vs plain "
              f"{out['flips']:.5f} flips, max |d| {out['max_abs_err']:.3g}, "
              f"means {out['mean_rel']:.2e} apart | vs wavefront "
              f"{out['wavefront_flips']:.4f} flips | rays {out['rays']:.0f} "
              f"vs {out['wavefront_rays']} | mean {out['mean']:.5f}",
              flush=True)
    return results


def extras_path_phase(device) -> dict:
    """Main path D: Sphere and Opacity (dense trace), hier_bridge_15k_env
    and the two material scenes (BVH trace) through render_progressive."""
    out = {}
    for name in EXTRAS_PATHS:
        scene, cam = _extras_scene(name, dict(EXTRAS_SCENES)[name], device)
        out[name] = _extras_path(name, scene, cam)
    return out


def _extras_path(name, scene, cam, tag="extras_path") -> dict:
    """One scene of main path D: RES² × ACCUMULATIONS through
    render_progressive with every count at 0 (exactly one megakernel
    launch a frame, no trace launch), its running mean against the eager
    loop's and the plain version's (_check_eager_mean, _check_plain_mean),
    and the kernel at the path's shape against its plain version; on the
    dense trace also the kernel's and the plain version's times and the
    bound."""
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    res = RES
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    path = _expect_megakernel(scene, settings, name)
    mega.prewarm_megakernel(scene)
    torch.cuda.synchronize()

    # The path, driven with every count at 0.
    _reset_counts()
    hdr = pt.render_progressive(scene, cam, res, res, ACCUMULATIONS,
                                settings)
    torch.cuda.synchronize()
    launches = mega.launch_count
    trace_launches = (dense.launch_count + hier.launch_count
                      + clustered.launch_count + vmem.launch_count)
    check(launches == ACCUMULATIONS, f"{name}: the path launched the "
          f"megakernel {launches} times for {ACCUMULATIONS} frames")
    check(trace_launches == 0, f"{name}: the path launched a trace "
          f"kernel {trace_launches} times")
    check(hdr.shape == (res, res, 3), f"image shape {tuple(hdr.shape)}")
    check(bool(torch.isfinite(hdr).all()), f"{name}: image is not finite")
    mean = float(hdr.mean())
    check(mean > 1e-3, f"{name}: image mean {mean} is not lit")
    png = os.path.join(REPO, "build", f"{name.lower()}_{res}.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    save_image(png, process(hdr, CameraEffectsSettings.preset()._replace(
        film_grain=0.0)))
    check(os.path.getsize(png) > 0, "PNG not written")

    # The kernel at the path's shape against its plain version. The dense
    # trace's kExtras instantiation runs in no cell, so it is timed here
    # beside its plain version and its bound.
    args, img, got_rays = _kernel_frame(scene, cam, res, 1, settings)
    cfg = args[-1]
    check(cfg.extras, f"{name}: not the kExtras instantiation")
    timed = not cfg.hier
    if timed:
        ms = _median_ms(lambda: mega.mesh_megakernel_cuda(*args), repeats=10,
                        warmup=2)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ref, _ = _plain_frame(scene, cam, res, 1, settings, stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    flips, max_err, _ = _gate(img, ref, f"{name} {res}: kernel vs plain",
                              KERNEL_FLIPS, KERNEL_MEAN)
    _check_eager_mean(name, scene, cam, res, settings, hdr)
    mean_flips = _check_plain_mean(name, scene, cam, res, settings, ref)
    out = dict(path=path, tris=cfg.n_tris, launches=launches, mean=mean,
               max_abs_err=max_err, flips=flips, plain_mean_flips=mean_flips)
    line = (f"{tag}/{name}: {path} | {res}x{res} {BOUNCES} bounces "
            f"x{ACCUMULATIONS} through render_progressive | megakernel "
            f"launches {launches}, trace-kernel launches {trace_launches} | "
            f"mean {mean:.4f} | kernel vs plain {flips:.5f} flips, max |d| "
            f"{max_err:.3g} | running mean bit-equal to the eager loop's, vs "
            f"plain {mean_flips:.5f} flips")
    if timed:
        # Bytes: per pixel 16 B out; the triangle and attribute tables and
        # every table of the extras once. Operations: the chunk box and
        # triangle tests that the plain version counted for its closest and
        # shadow traces (an any-hit query per lit shaded hit, or the
        # march's steps), and the shading of every iteration that shaded a
        # hit (shade_ops).
        rays = float(got_rays.sum())
        traces = (rays / 2 + stats.get("shadow_traces", 0)
                  + stats.get("march_traces", 0))
        table_bytes = (sum(t.numel() * 4 for t in args[-2] if t is not None)
                       + (64 + 4 * mega.ATTR_ROWS) * cfg.n_tris)
        out.update(ms=ms, plain_ms=plain_ms, **roofline(
            16 * res * res + table_bytes,
            BOX_FLOPS * stats["box_tests"] + MT_FLOPS * stats["tri_tests"]
            + shade_ops(cfg.ris_count, cfg.has_coat, cfg.extras)
            * stats["shaded"]))
        line += (f" | kernel {ms:.3f} ms (median of 10), plain "
                 f"{plain_ms:.0f} ms (one run) | {traces:.0f} traces, "
                 f"{stats['box_tests'] / traces:.1f} chunk box and "
                 f"{stats['tri_tests'] / traces:.1f} triangle tests per "
                 f"trace, tables {table_bytes / 1024:.0f} KiB | bound "
                 f"{out['bound_ms']:.5f} ms by {out['bound_by']}")
    print(f"{line} | {os.path.relpath(png, REPO)}", flush=True)
    return out


def viewer_phase(device) -> None:
    """Main path D from its entry point: the viewer's CLI on Sphere and
    Opacity. The viewer's settings are a plain RenderSettings, so Opacity's
    shadow rays are any-hit queries here: that frame against the plain
    version too."""
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    for name in ("Sphere", "Opacity"):
        png = os.path.join(REPO, "build", f"viewer_{name.lower()}.png")
        if os.path.exists(png):
            os.remove(png)
        _reset_counts()
        simple_viewer.main(["--scene", name, "-n", str(ACCUMULATIONS), "-o",
                            png])
        torch.cuda.synchronize()
        launches = mega.launch_count
        trace_launches = (dense.launch_count + hier.launch_count
                          + clustered.launch_count + vmem.launch_count)
        check(launches == ACCUMULATIONS, f"viewer {name}: launched the "
              f"megakernel {launches} times for {ACCUMULATIONS} frames")
        check(trace_launches == 0, f"viewer {name}: launched a trace kernel "
              f"{trace_launches} times")
        check(os.path.getsize(png) > 0, "PNG not written")
        print(f"viewer/{name}: simple_viewer --scene {name} -n "
              f"{ACCUMULATIONS} ({RES}x{RES}, {BOUNCES} bounces) | megakernel "
              f"launches {launches}, trace-kernel launches {trace_launches} | "
              f"{os.path.relpath(png, REPO)}", flush=True)

    scene, cam = _extras_scene("Opacity", True, device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    _expect_megakernel(scene, settings, "Opacity at the viewer's settings")
    args, img, got_rays = _kernel_frame(scene, cam, SMALL_RES, 1, settings)
    cfg = args[-1]
    check(cfg.extras and cfg.any_coverage and cfg.shadow_steps == 0,
          "Opacity at the viewer's settings: cutouts with any-hit shadows")
    _, ref, ref_rays = _plain_frame(scene, cam, SMALL_RES, 1, settings)
    flips, max_err, mean_rel = _gate(
        img, ref, "Opacity at the viewer's settings: kernel vs plain",
        KERNEL_FLIPS, KERNEL_MEAN)
    rays, plain_rays = float(got_rays.sum()), float(ref_rays.sum())
    check(abs(rays - plain_rays) <= 0.02 * plain_rays,
          f"Opacity at the viewer's settings: {rays} rays vs the plain "
          f"version's {plain_rays}")
    print(f"viewer/Opacity settings: {SMALL_RES}x{SMALL_RES} cutouts with "
          f"any-hit shadow rays | vs plain {flips:.5f} flips, max |d| "
          f"{max_err:.3g}, means {mean_rel:.2e} apart | rays {rays:.0f} vs "
          f"{plain_rays:.0f}", flush=True)


PROFILED_SCENES = (("CornellBox", True), ("Sphere", True), ("Opacity", True),
                   (BRIDGE_SCENE, False))
MAX_FRAME_LAUNCHES = 10


TRANSMISSIVE_SCENES = ("Glass", "Test")
VIEWER_ACCUMULATIONS = 2
GLASS_GATE_RES = 64


def viewer_scenes_phase(device, card, path_d) -> dict:
    """Phase 21: Glass and Test through render_progressive at the viewer's
    defaults; the material scenes' results from main path D (``path_d``);
    a 64² Glass frame on the card against the CPU's."""
    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    res, n, out = RES, VIEWER_ACCUMULATIONS, {}
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    for name in TRANSMISSIVE_SCENES:
        scene, cam = SCENES[name](aspect=1.0, device=device)
        path = pt.explain_render_path(scene, settings)
        check(path == "wavefront: Transmissive shading model",
              f"{name}: {path}")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        hdr = pt.render_progressive(scene, cam, res, res, n, settings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(B1=dense.launch_count, B3=mega.launch_count,
                      B4=hier.launch_count, B6=clustered.launch_count,
                      B7=vmem.launch_count)
        check(counts["B1"] > 0 and counts["B3"] == 0
              and counts["B4"] + counts["B6"] + counts["B7"] == 0,
              f"{name}: launches {counts}, expected B1 only")
        check(hdr.shape == (res, res, 3), f"image shape {tuple(hdr.shape)}")
        check(bool(torch.isfinite(hdr).all()), f"{name}: image is not finite")
        mean = float(hdr.mean())
        check(mean > 1e-3, f"{name}: image mean {mean} is not lit")
        frames = []
        for acc in (n, n + 1, n + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt.render_sample_fast(scene, cam, res, res, acc, settings)
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(path=path, launches=counts, seconds=seconds,
                         mean=mean, frame_ms=statistics.median(frames),
                         tris=int(scene.tri_verts.shape[0]))
        print(f"viewer_scenes/{name}: {path} | {out[name]['tris']} triangles "
              f"| {res}x{res} {BOUNCES} bounces x{n} through "
              f"render_progressive in {seconds:.3f} s | launches {counts} | "
              f"mean {mean:.4f} | render_sample_fast frame "
              f"{out[name]['frame_ms']:.2f} ms (median of 3) | {card}",
              flush=True)
    for name in MATERIAL_SCENES:
        d = path_d[name]
        out[name] = d
        print(f"viewer_scenes/{name}: {d['path']} | {d['tris']} triangles | "
              f"{res}x{res} {BOUNCES} bounces x{ACCUMULATIONS} through "
              f"render_progressive on main path D | launches B3 "
              f"{d['launches']}, no trace kernel | mean {d['mean']:.4f} | "
              f"kernel vs plain {d['flips']:.5f} flips | {card}", flush=True)

    # Glass at 64² on the card (B1) against the CPU (its plain version).
    gres = GLASS_GATE_RES
    scene, cam = SCENES["Glass"](aspect=1.0, device=device)
    cpu_scene, cpu_cam = SCENES["Glass"](aspect=1.0,
                                         device=torch.device("cpu"))
    _reset_counts()
    img = pt.render_sample(scene, cam, gres, gres, 1, settings)
    torch.cuda.synchronize()
    check(dense.launch_count > 0, "glass gate: no B1 launch on the card")
    ref = pt.render_sample(cpu_scene, cpu_cam, gres, gres, 1, settings)
    flips, max_err, rel = _gate(img.reshape(-1, 3).cpu(), ref.reshape(-1, 3),
                                f"Glass {gres}: card vs cpu")
    out["glass_gate"] = dict(flips=flips, max_abs_err=max_err, mean_rel=rel)
    print(f"viewer_scenes/glass_gate: {gres}x{gres} {BOUNCES} bounces, card "
          f"(B1) vs cpu (plain) | {flips:.5f} of pixels off by > 1e-3 "
          f"(budget 0.03), means {rel:.2e} apart (budget 0.02), max "
          f"|difference| {max_err:.3e}", flush=True)
    out["clip"] = fresh_process("clip")
    return out


def clip_profile_phase(device) -> dict:
    """The JAX-rule helpers on card tensors: torch.profiler's host-to-device
    copies over 100 calls of each (none) and a call each under sync debug
    mode raising."""
    from torch.profiler import ProfilerActivity, profile

    from bifrost3d_tpu_torch.math.clip import absolute, clip, maximum, minimum
    x = torch.rand(65536, device=device, requires_grad=True)

    def calls():
        y = clip(x, 0.25, 0.75) + maximum(x, 0.5) + minimum(x, 0.5)
        return (y + absolute(x - 0.5)).sum()
    calls().backward()                     # the bounds' first use
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            calls().backward()
        torch.cuda.synchronize()
    copies = sum(e.count for e in prof.key_averages()
                 if "HtoD" in e.key or "cudaMemcpy" in e.key)
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(copies == 0, f"clip helpers: {copies} host-to-device copies in "
          "100 calls")
    print(f"clip: clip / maximum / minimum / absolute on card tensors, 100 "
          f"calls with their backward: {copies} host-to-device copies, no "
          f"host sync under sync debug mode", flush=True)
    return dict(copies=copies)


def frame_profile_phase(device) -> dict:
    """render_sample_fast's frame after a scene's first, for CornellBox,
    Sphere, Opacity and the 49,678-triangle bridge at 512²: CUDA launches
    and host syncs per frame over three frames from torch.profiler (at most
    MAX_FRAME_LAUNCHES launches, no sync), with torch's sync debug mode set
    to raise, so a synchronising torch op fails the phase. Then
    _walk_call_profile."""
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    for name, viewer in PROFILED_SCENES:
        scene, cam = _extras_scene(name, viewer, device)
        settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
        pt.render_sample_fast(scene, cam, RES, RES, 0, settings)
        torch.cuda.synchronize()
        frames = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                with record_function("chip_smoke_frames"):
                    for acc in range(1, frames + 1):
                        pt.render_sample_fast(scene, cam, RES, RES, acc,
                                              settings)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # Runtime calls on the host inside the frames' window; kernels that
        # ran on the card over the whole profile (only the frames).
        events = prof.events()
        window = next(e for e in events if e.name == "chip_smoke_frames")
        inside = [e for e in events if window.time_range.start
                  <= e.time_range.start <= window.time_range.end]
        launches = sum("LaunchKernel" in e.name for e in inside) / frames
        memsets = sum("Memset" in e.name for e in inside) / frames
        syncs = sum("Synchronize" in e.name or e.name == "cudaMemcpy"
                    for e in inside) / frames
        kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      for e in events) / frames
        check(syncs == 0, f"profile/{name}: {syncs} host syncs per frame")
        check(max(launches + memsets, kernels) <= MAX_FRAME_LAUNCHES,
              f"profile/{name}: {launches + memsets} launches, {kernels} "
              "kernels per frame")
        out[name] = dict(launches=launches, memsets=memsets, syncs=syncs,
                         kernels=kernels)
        print(f"profile/{name}: render_sample_fast {RES}x{RES} after the "
              f"scene's first frame | per frame {launches:.1f} kernel-launch "
              f"calls, {memsets:.1f} memsets, {kernels:.1f} device activities "
              f"and {syncs:.0f} host syncs (torch.profiler over {frames} "
              f"frames; sync debug mode raised nothing)", flush=True)
    out["vmem_calls"] = _walk_call_profile(device)
    return out


def _walk_call_profile(device, calls=3) -> dict:
    """Warm calls of the resident-cluster walk (B7) on the 16,130-triangle
    soup, closest hit and any-hit, with t_min, t_max and the live count as
    device tensors, under torch.profiler with torch's sync debug mode set
    to raise: exactly one kernel-launch call, no memset and no host sync
    per call, and where the card's trace is there one kernel per call,
    between the range's spin kernels."""
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from torch.profiler import ProfilerActivity, profile, record_function
    walk = vmem.pack_vmem(_soups(device)["sphere"])
    o, d, t_max = _rays(np.random.default_rng(5), "sphere", device)
    t_min = torch.tensor(1e-4, device=device)
    live = torch.tensor(R // 3, device=device)
    queries = {"closest": False, "any_hit": True}
    for any_hit in queries.values():
        vmem.vmem_intersect(walk, o, d, t_min, t_max, any_hit, live)
    torch.cuda.synchronize()
    before = vmem.launch_count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for name, any_hit in queries.items():
                spin()
                with record_function(f"walk_calls:{name}"):
                    for _ in range(calls):
                        vmem.vmem_intersect(walk, o, d, t_min, t_max,
                                            any_hit, live)
                    torch.cuda.synchronize()
            spin()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    check(vmem.launch_count - before == calls * len(queries),
          f"profile/vmem: {vmem.launch_count - before} B7 launches counted")
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    on_card = _device_ranges(events, list(queries))
    out = {}
    for name in queries:
        # Host calls in the range's window on the host's clock; kernels
        # between its spin kernels on the card's.
        window = next(e.time_range for e in events
                      if e.name == f"walk_calls:{name}" and e.device_type != cuda)
        host = [e.name for e in events if e.device_type != cuda
                and window.start <= e.time_range.start <= window.end]
        launches = sum("LaunchKernel" in n for n in host) / calls
        memsets = sum("Memset" in n for n in host) / calls
        # The range's own synchronise ends it: it is no call's.
        syncs = (sum("Synchronize" in n or n == "cudaMemcpy"
                     for n in host) - 1) / calls
        kernels = (0 if on_card is None else
                   sum("vmem_intersect_kernel" in e.name
                       for e in on_card[name]) / calls)
        check(launches == 1 and memsets == 0 and syncs <= 0,
              f"profile/vmem/{name}: per call {launches} launches, {memsets} "
              f"memsets, {syncs} host syncs")
        check(on_card is None or kernels == 1, f"profile/vmem/{name}: "
              f"{kernels} B7 kernels per call")
        out[name] = dict(launches=launches, memsets=memsets, syncs=syncs,
                         kernels=kernels)
        print(f"profile/vmem/{name}: warm B7 call, 65,536 rays x 16,130 "
              f"tris, bounds and live count on the device | per call "
              f"{launches:.0f} kernel-launch call, {memsets:.0f} memsets, "
              f"{max(syncs, 0):.0f} host syncs and "
              + ("the card's trace lost" if kernels == 0 else
                 f"{kernels:.0f} B7 kernel")
              + f" (torch.profiler over {calls} calls; sync debug mode raised"
              " nothing)", flush=True)
    return out


# -- train: gradients through the wavefront (main path E) -------------------------

TRAIN_RES, TRAIN_BOUNCES, TRAIN_STEPS = 256, 2, 3
LARGE_TRAIN_RES, LARGE_TRAIN_BOUNCES = 512, 4
# The gradient with the trace on its plain version against the kernel's:
# hits differ only at ties (nvcc's FMA contraction), a handful of pixels'
# paths in 65,536.
PLAIN_TRACE_RTOL = 1e-3


def _tint_step(scene, cam, target, res, accumulation, settings):
    """bench.py's bench_backward step, in the port: loss = mean((render_sample
    - target)²) and its gradient over materials.tint, with every launch
    count at 0 before it → dict(loss, grad, ms: host clock to a synchronise,
    peak: torch.cuda.max_memory_allocated over the step, extra: that peak
    above the memory held before it, launches of B1 and B4 in the forward
    and in the backward)."""
    from bifrost3d_tpu_torch.diff import image_l2_loss
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_counts()
    t0 = time.perf_counter()
    tint = scene.materials.tint.detach().clone().requires_grad_()
    img = pt.render_sample(
        scene._replace(materials=scene.materials._replace(tint=tint)), cam,
        res, res, accumulation, settings)
    loss = image_l2_loss(img, target)
    forward = (dense.launch_count, hier.launch_count)
    (grad,) = torch.autograd.grad(loss, tint)
    value = float(loss.detach())          # synchronises
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return dict(loss=value, grad=grad, ms=ms, peak=peak, extra=peak - held,
                fwd=forward, bwd=(dense.launch_count - forward[0],
                                  hier.launch_count - forward[1]))


def _train_variants(settings):
    """Plain reverse mode, the detached-replay VJP and remat."""
    plain = settings._replace(remat_bounces=False, detached_replay_vjp=False)
    return {"plain": plain,
            "replay": plain._replace(detached_replay_vjp=True),
            "remat": plain._replace(remat_bounces=True)}


def _gib(n_bytes) -> str:
    return f"{n_bytes / 2**30:.3f} GiB"


def train_phase(device, card) -> dict:
    """Main path E, the gradient path: bench_backward's step on CornellBox
    at 256², 2 bounces, plain, under the detached-replay VJP and under
    remat; the same plain step with the trace on its plain version; one
    plain step on the torus grid (B4 only); optimize_materials on
    tests/test_diff.py's scene; the edge gradients against central
    differences; the three variants at 512², 4 bounces."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES, create_cornell_box
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    out = {}
    scene, cam = create_cornell_box(device=device)
    base = pt.settings_for_scene(scene, max_bounce_count=TRAIN_BOUNCES)
    iters = TRAIN_BOUNCES + 1 + base.passthrough_slack
    with torch.no_grad():
        target = pt.render_sample(scene, cam, TRAIN_RES, TRAIN_RES, 0, base)
    _tint_step(scene, cam, target, TRAIN_RES, 1, base)     # warm caches
    runs = {}
    for name, settings in _train_variants(base).items():
        steps = [_tint_step(scene, cam, target, TRAIN_RES, n, settings)
                 for n in range(1, TRAIN_STEPS + 1)]
        runs[name] = steps
        for step in steps:
            check(bool(torch.isfinite(step["grad"]).all()),
                  f"train/{name}: gradient is not finite")
            check(step["fwd"] == (2 * iters, 0),
                  f"train/{name}: forward launches (B1, B4) {step['fwd']}, "
                  f"expected ({2 * iters}, 0)")
        bwd = {step["bwd"] for step in steps}
        want = (2 * iters, 0) if name == "remat" else (0, 0)
        check(bwd == {want}, f"train/{name}: backward launches (B1, B4) "
              f"{sorted(bwd)}, expected {want}")
        out[name] = dict(
            ms=statistics.median(s["ms"] for s in steps),
            peak=max(s["peak"] for s in steps),
            extra=max(s["extra"] for s in steps),
            fwd_launches=steps[0]["fwd"][0], bwd_launches=steps[0]["bwd"][0],
            launches=sum(s["fwd"][0] + s["bwd"][0] for s in steps))
    plain = runs["plain"]
    check(float(plain[0]["grad"].abs().max()) > 0.0,
          "train/plain: the tint gradient is zero")
    for name in ("replay", "remat"):
        worst = 0.0
        for a, b in zip(plain, runs[name]):
            check(a["loss"] == b["loss"], f"train/{name}: loss {b['loss']} "
                  f"vs plain {a['loss']}")
            check(bool(torch.allclose(b["grad"], a["grad"], rtol=1e-5,
                                      atol=1e-8)),
                  f"train/{name}: gradient differs from plain beyond rtol "
                  "1e-5, atol 1e-8")
            worst = max(worst, float(((b["grad"] - a["grad"]).abs()
                                      / a["grad"].abs().clamp_min(1e-30))
                                     .max()))
        out[name]["max_rel"] = worst
    for name, r in out.items():
        extra = (f" | max rel. gradient difference vs plain {r['max_rel']:.3e}"
                 if "max_rel" in r else "")
        print(f"train/{name}: CornellBox {TRAIN_RES}x{TRAIN_RES} "
              f"{TRAIN_BOUNCES} bounces, value_and_grad over materials.tint "
              f"| step {r['ms']:.2f} ms (median of {TRAIN_STEPS}) | peak "
              f"{_gib(r['peak'])} ({_gib(r['extra'])} above the scene) | B1 "
              f"launches a step: {r['fwd_launches']} forward, "
              f"{r['bwd_launches']} backward; B4 0{extra} | {card}",
              flush=True)

    # The plain step with the trace on its plain version, same card.
    with mock.patch.object(dense, "pallas_intersect",
                           dense.dense_intersect_reference):
        ref = _tint_step(scene, cam, target, TRAIN_RES, 1,
                         _train_variants(base)["plain"])
    check(ref["fwd"] == (0, 0), "the plain trace launched a kernel")
    g, r = plain[0]["grad"], ref["grad"]
    scale = float(g.abs().max())
    diff = (g - r).abs()
    rel = float(diff.max()) / scale
    check(rel <= PLAIN_TRACE_RTOL, f"train: gradient with the plain trace "
          f"differs by {rel:.3e} of its largest component")
    out["plain_trace"] = dict(max_rel=rel, loss_rel=abs(
        ref["loss"] - plain[0]["loss"]) / plain[0]["loss"], ms=ref["ms"])
    print(f"train/plain-trace: the plain step with the trace on its plain "
          f"version | gradient within {rel:.3e} of the kernel's largest "
          f"component (gate {PLAIN_TRACE_RTOL}) | loss rel. difference "
          f"{out['plain_trace']['loss_rel']:.3e} | step {ref['ms']:.1f} ms | "
          f"{card}", flush=True)

    # The torus grid: B4 only.
    t_scene, t_cam = TEST_SCENES["torus_grid"](device=device)
    t_settings = _train_variants(pt.settings_for_scene(
        t_scene, max_bounce_count=TRAIN_BOUNCES))["plain"]
    with torch.no_grad():
        t_target = torch.zeros((TRAIN_RES, TRAIN_RES, 3), device=device)
    _tint_step(t_scene, t_cam, t_target, TRAIN_RES, 1, t_settings)
    torus = _tint_step(t_scene, t_cam, t_target, TRAIN_RES, 1, t_settings)
    check(torus["fwd"][0] == 0 and torus["fwd"][1] > 0 and
          torus["bwd"] == (0, 0), f"train/torus_grid: launches (B1, B4) "
          f"forward {torus['fwd']}, backward {torus['bwd']}")
    check(bool(torch.isfinite(torus["grad"]).all())
          and float(torus["grad"].abs().max()) > 0.0,
          "train/torus_grid: gradient not finite or zero")
    out["torus"] = dict(ms=torus["ms"], peak=torus["peak"],
                        extra=torus["extra"], launches=torus["fwd"][1])
    print(f"train/torus_grid: {int(t_scene.tri_verts.shape[0])} triangles "
          f"{TRAIN_RES}x{TRAIN_RES} {TRAIN_BOUNCES} bounces, one plain step "
          f"| B4 launches {torus['fwd'][1]} forward, 0 backward; B1 0 | step "
          f"{torus['ms']:.1f} ms | peak {_gib(torus['peak'])} "
          f"({_gib(torus['extra'])} above the scene) | {card}", flush=True)
    del t_scene, t_cam

    out["optimize"] = _optimize_phase(device, card)
    out["edges"] = _edge_phase(device, card)

    # 512², 4 bounces: one step of each variant.
    settings = pt.settings_for_scene(scene, max_bounce_count=LARGE_TRAIN_BOUNCES)
    with torch.no_grad():
        target = pt.render_sample(scene, cam, LARGE_TRAIN_RES,
                                  LARGE_TRAIN_RES, 0, settings)
    large = {}
    # A first step grows the caching allocator to the plain step's peak,
    # so that no variant's time includes that growth.
    _tint_step(scene, cam, target, LARGE_TRAIN_RES, 1,
               _train_variants(settings)["plain"])
    for name, variant in _train_variants(settings).items():
        step = _tint_step(scene, cam, target, LARGE_TRAIN_RES, 1, variant)
        check(bool(torch.isfinite(step["grad"]).all()),
              f"train/{name} {LARGE_TRAIN_RES}²: gradient is not finite")
        large[name] = step
        print(f"train/{name}: CornellBox {LARGE_TRAIN_RES}x{LARGE_TRAIN_RES} "
              f"{LARGE_TRAIN_BOUNCES} bounces, one step | {step['ms']:.1f} ms "
              f"| peak {_gib(step['peak'])} ({_gib(step['extra'])} above the "
              f"scene) | B1 launches {step['fwd'][0]} forward, "
              f"{step['bwd'][0]} backward | {card}", flush=True)
    for name in ("replay", "remat"):
        check(large[name]["loss"] == large["plain"]["loss"] and bool(
            torch.allclose(large[name]["grad"], large["plain"]["grad"],
                           rtol=1e-5, atol=1e-8)),
              f"train/{name} {LARGE_TRAIN_RES}²: differs from plain")
    out["large"] = {name: dict(ms=s["ms"], peak=s["peak"], extra=s["extra"])
                    for name, s in large.items()}
    return out


def _optimize_phase(device, card) -> dict:
    """optimize_materials on tests/test_diff.py:27-35's scene, 1 bounce,
    Adam at lr 0.1, fixed samples: at test_recover_tint's 16 x 12 and 16
    steps under its gate (the loss below a quarter of its start, the tint
    within 0.15 of the target); at 64 x 48, 8 steps, against the same run
    with the trace on its plain version (every loss within rtol 1e-3). At 64 x 48 the gate does
    not hold for this estimator, in JAX as in the port: the losses are
    printed and the gate's verdict with them."""
    from bifrost3d_tpu_torch.diff import optimize_materials
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.geometry.creation import make_sphere
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.lights.types import LIGHT_SPHERE, LightArray
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    from bifrost3d_tpu_torch.scene.materials import MaterialArray, dielectric
    from bifrost3d_tpu_torch.scene.render_scene import build_render_scene

    def make_scene(tint):
        return build_render_scene(
            [(make_sphere(radius=0.5, slices=24, stacks=12), 0, None)],
            MaterialArray.build([dielectric(tint, 0.6)], device=device),
            LightArray.build([{"kind": LIGHT_SPHERE, "position": (0, 2.0, 1.0),
                               "radius": 0.2, "power": (30, 30, 30)}],
                             device=device),
            environment_map=np.full((16, 32, 3), 0.2, np.float32),
            device=device)

    cam = perspective_camera(eye=(0, 0.5, 2.2), target=(0, 0, 0),
                             device=device)
    settings = pt.RenderSettings(max_bounce_count=1, next_event_sample_count=1)
    start = make_scene((0.4, 0.6, 0.3))

    def run(w, h, steps):
        with torch.no_grad():
            target = pt.render_sample(make_scene((0.8, 0.2, 0.5)), cam, w, h,
                                      0, settings)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        result = optimize_materials(start, cam, target, w, h, steps=steps,
                                    learning_rate=0.1, vary_samples=False,
                                    settings=settings)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        tint = result.scene.materials.tint[0].tolist()
        gate = (result.losses[-1] < 0.25 * result.losses[0] and all(
            abs(a - b) <= 0.15 for a, b in zip(tint, (0.8, 0.2, 0.5))))
        return dict(losses=result.losses, tint=tint, step_ms=step_ms,
                    gate=gate, launches=dense.launch_count)

    out = {}
    for w, h, steps in ((16, 12, 16), (64, 48, 8)):
        r = run(w, h, steps)
        want = 2 * (settings.max_bounce_count + 1
                    + settings.passthrough_slack) * steps
        check(r["launches"] == want, f"optimize {w}x{h}: {r['launches']} B1 "
              f"launches in {steps} steps, expected {want}")
        check(all(math.isfinite(x) for x in r["losses"] + r["tint"]),
              f"optimize {w}x{h}: not finite")
        line = (f"train/optimize_materials: {w}x{h} 1 bounce, {steps} Adam "
                f"steps, lr 0.1 | tint {[round(x, 4) for x in r['tint']]} "
                f"(target 0.8, 0.2, 0.5) | losses "
                f"{' '.join(f'{x:.4e}' for x in r['losses'])} | "
                f"test_recover_tint's gate: "
                f"{'met' if r['gate'] else 'not met'} | "
                f"{r['step_ms']:.1f} ms a step | {card}")
        if (w, h) == (16, 12):
            check(r["gate"], f"optimize {w}x{h}: gate not met: {r}")
        else:
            with mock.patch.object(dense, "pallas_intersect",
                                   dense.dense_intersect_reference):
                ref = run(w, h, steps)
            worst = max(abs(a - b) / b for a, b in zip(r["losses"],
                                                       ref["losses"]))
            check(worst <= 1e-3, f"optimize {w}x{h}: losses differ from the "
                  f"plain trace's by {worst:.3e}")
            r["plain_trace_max_rel"] = worst
            line += f" | losses within {worst:.3e} of the plain trace's"
        out[f"{w}x{h}"] = r
        print(line, flush=True)
    return out


def _edge_phase(device, card) -> dict:
    """edge_position_gradient on tests/test_edge_grad.py's single sphere and
    edge_translation_gradient on tests/test_diff.py:129-190's floating box,
    each against central differences of its forward, with JAX's
    tolerances."""
    from bifrost3d_tpu_torch.diff import edge_grad, mesh_edge_grad
    from bifrost3d_tpu_torch.geometry.creation import make_box, make_plane
    from bifrost3d_tpu_torch.geometry.traverse import intersect_triangles_brute
    from bifrost3d_tpu_torch.scene.camera import (
        camera_ray_directions, perspective_camera)
    from bifrost3d_tpu_torch.scene.spheres import sphere_scene_from_numpy

    w, h = 64, 48
    base = np.asarray([27.0, 16.5, 47.0], np.float32)

    def sphere(center):
        z = np.zeros
        return sphere_scene_from_numpy(dict(
            position=[center], radius=[16.5], emission=[[1.0, 1.0, 1.0]],
            color=z((1, 3)), bsdf=z(1, np.int32), medium_sigma_t=z(1),
            medium_albedo=z(1), medium_g=z(1)), device=device)

    def fwd(c):
        return float(edge_grad.direct_emission_image(sphere(c), w, h,
                                                     samples_per_pixel=16))

    g = edge_grad.edge_position_gradient(sphere(base), 0, w, h,
                                         n_samples=2048).cpu().numpy()
    sphere_fd = []
    for axis, rtol, atol in ((0, 0.2, 3e-6), (2, 0.05, 0.0)):
        e = np.zeros(3, np.float32)
        e[axis] = 1.0
        fd = (fwd(base + e) - fwd(base - e)) / 2.0
        sphere_fd.append(fd)
        check(abs(g[axis] - fd) <= atol + rtol * abs(fd),
              f"edge/sphere axis {axis}: {g[axis]} vs FD {fd}")
    check(g[2] > 1e-4, f"edge/sphere: {g}")

    box, floor = make_box(size=0.8), make_plane(size=6.0)

    def tris(mesh):
        return torch.tensor(np.asarray(mesh.positions)[
            np.asarray(mesh.indices)], dtype=torch.float32, device=device)

    floor_t, box_t = tris(floor), tris(box)

    def first_hit_tint(t):
        soup = torch.cat([floor_t, box_t + t], 0)

        def fn(origin, direction):
            hit = intersect_triangles_brute(soup, origin, direction, 1e-4)
            return torch.where(hit.prim >= 0, torch.where(
                hit.prim >= floor_t.shape[0], 0.55, 0.2), 0.0)
        return fn

    cam = perspective_camera(eye=(1.3, 1.5, 2.4), target=(0, 0.3, 0),
                             device=device)
    m = 384
    u = (torch.arange(m, dtype=torch.float32, device=device) + 0.5) / m
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    o, d = camera_ray_directions(
        cam, torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))
    box_base = torch.tensor([0.05, 0.62, 0.0], device=device)
    edges = mesh_edge_grad.MeshEdges.build(box.positions, box.indices,
                                           device=device)
    gb = mesh_edge_grad.edge_translation_gradient(
        cam, edges, box_base, first_hit_tint(box_base), samples_per_edge=64,
        edge_eps=1e-3).cpu().numpy()
    check(bool(np.all(np.isfinite(gb))) and np.max(np.abs(gb)) > 1e-3,
          f"edge/box: {gb}")
    box_fd, step = [], 0.06
    for axis in (0, 1):
        e = torch.zeros(3, device=device)
        e[axis] = step
        fd = float(torch.mean(first_hit_tint(box_base + e)(o, d))
                   - torch.mean(first_hit_tint(box_base - e)(o, d))) / (2 * step)
        box_fd.append(fd)
        check(abs(gb[axis] - fd) <= 2e-4 + 0.12 * abs(fd),
              f"edge/box axis {axis}: {gb[axis]} vs FD {fd}")
    print(f"train/edges: single sphere boundary term {g.tolist()} vs central "
          f"differences (axes 0, 2) {sphere_fd}; floating box {gb.tolist()} "
          f"vs (axes 0, 1) {box_fd} | JAX's tolerances | {card}", flush=True)
    return dict(sphere=g.tolist(), sphere_fd=sphere_fd, box=gb.tolist(),
                box_fd=box_fd)


def train_profile_phase(device) -> dict:
    """One plain, one replay and one remat step of the Cornell train step
    under torch.profiler (device activity only), each forward and backward
    ending in a synchronise, with a spin kernel (``torch.cuda._sleep``)
    before each part and after the last: the B1 kernels the card ran in
    each part (by the kernel's name, one per correlation id), found
    between its spin kernels on the card's own clock, beside the wrapper's
    counts; each part's host time and its device activities. The raw
    profiler events are read (``kineto_results``): building torch's event
    tree over the ~450,000 of three steps took 31–72 s on an H100
    machine's host."""
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.diff import image_l2_loss
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from torch.profiler import ProfilerActivity, profile

    scene, cam = create_cornell_box(device=device)
    base = pt.settings_for_scene(scene, max_bounce_count=TRAIN_BOUNCES)
    with torch.no_grad():
        target = pt.render_sample(scene, cam, TRAIN_RES, TRAIN_RES, 0, base)
    variants = _train_variants(base)
    _tint_step(scene, cam, target, TRAIN_RES, 1, variants["plain"])
    counts, parts, wall_ms = {}, [], {}

    def part(name, fn):
        spin()                         # the part's first spin kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms[name] = (time.perf_counter() - t0) * 1e3
        parts.append(name)
        return out

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, settings in variants.items():
            tint = scene.materials.tint.detach().clone().requires_grad_()
            diff = scene._replace(materials=scene.materials._replace(
                tint=tint))
            _reset_counts()
            loss = part(f"{name}:forward", lambda: image_l2_loss(
                pt.render_sample(diff, cam, TRAIN_RES, TRAIN_RES, 1,
                                 settings), target))
            fwd = dense.launch_count
            part(f"{name}:backward", lambda: torch.autograd.grad(loss, tint))
            counts[name] = (fwd, dense.launch_count - fwd)
        spin()                         # the last part's end
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device_events = sorted(
        (e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda)
    spins = [i for i, e in enumerate(device_events) if "spin_kernel" in e[2]]
    check(len(spins) == len(parts) + 1, f"train profile: {len(spins)} spin "
          f"kernels on the card for {len(parts)} parts")
    kernels, activities, busy_ms = {}, {}, {}
    for name, first, last in zip(parts, spins, spins[1:]):
        inside = device_events[first + 1:last]
        kernels[name] = len({e[3] for e in inside
                             if "dense_intersect_kernel" in e[2]})
        activities[name] = len(inside)
        busy_ms[name] = sum(e[1] - e[0] for e in inside) / 1e6
    return {"kernels": kernels, "counts": counts, "activities": activities,
            "busy_ms": busy_ms, "wall_ms": wall_ms,
            "iters": TRAIN_BOUNCES + 1 + base.passthrough_slack}


def train_profile(result, card) -> None:
    """Check and print train_profile_phase's counts: B1 kernels on the card
    per forward and backward of each variant, equal to the wrapper's
    counts, none in a plain or replay backward."""
    iters = result["iters"]
    for name in ("plain", "replay", "remat"):
        fwd, bwd = (result["kernels"][f"{name}:{part}"]
                    for part in ("forward", "backward"))
        counted = tuple(result["counts"][name])
        want = (2 * iters, 2 * iters if name == "remat" else 0)
        check((fwd, bwd) == want == counted,
              f"train profile/{name}: B1 kernels on the card (forward, "
              f"backward) {(fwd, bwd)}, counted {counted}, expected {want}")
        parts = " | ".join(
            f"{part}: {result['activities'][f'{name}:{part}']} device "
            f"activities, busy {result['busy_ms'][f'{name}:{part}']:.1f} of "
            f"{result['wall_ms'][f'{name}:{part}']:.1f} ms"
            for part in ("forward", "backward"))
        print(f"train profile/{name}: torch.profiler saw {fwd} B1 kernels in "
              f"the forward and {bwd} in the backward of one step (the "
              f"wrapper counted {counted}) | {parts} | {card}", flush=True)


# -- phase 22: the user's own files ------------------------------------------

FILES_DIR = os.path.join(REPO, "build", "files")
FILES_GATE_RES = 128
GLTF_ACCUMULATIONS = 2
ENV_ACCUMULATIONS = 2
SKY_W, SKY_H = 1024, 512
TEXTURE_SIZE = 1024


def _trace_counts() -> dict:
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    return dict(B1=dense.launch_count, B2_B3=mega.launch_count,
                B4=hier.launch_count, B6=clustered.launch_count,
                B7=vmem.launch_count)


def _viewer(argv, expect, what) -> dict:
    """simple_viewer.main(argv) on the card with every count at 0 before →
    its launches; each kernel of ``expect`` must have launched ("> 0") or
    launched that many times, every other kernel not at all."""
    from bifrost3d_tpu_torch.apps import simple_viewer
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    simple_viewer.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _trace_counts()
    for name, n in counts.items():
        want = expect.get(name, 0)
        check(n > 0 if want == "> 0" else n == want,
              f"{what}: launches {counts}, expected {expect}")
    return dict(counts=counts, seconds=seconds)


def _timed_frames(scene, cam, res, settings, first, n=3) -> dict:
    """n render_sample_fast frames after the ones already run → median,
    min and max ms, and each kernel's launches a frame."""
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    times = []
    torch.cuda.synchronize()
    _reset_counts()
    for acc in range(first, first + n):
        t0 = time.perf_counter()
        pt.render_sample_fast(scene, cam, res, res, acc, settings)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_frame = {k: v / n for k, v in _trace_counts().items() if v}
    return dict(ms=statistics.median(times), ms_min=min(times),
                ms_max=max(times), per_frame=per_frame)


def _sky(width=SKY_W, height=SKY_H) -> np.ndarray:
    """A latlong sky: a zenith-to-horizon gradient, a darker ground and a
    sun of radiance 4,000 about 0.5 degrees across."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    up = np.clip(1.0 - 2.0 * v, -1.0, 1.0)[:, None, None]
    zenith = np.asarray([0.25, 0.45, 1.1])
    horizon = np.asarray([0.95, 0.95, 1.0])
    ground = np.asarray([0.12, 0.10, 0.09])
    sky = np.where(up > 0, horizon + (zenith - horizon) * np.sqrt(
        np.clip(up, 0.0, None)), ground * np.ones_like(up))
    sky = np.broadcast_to(sky, (height, width, 3)).copy()
    du = np.minimum(np.abs(u[None, :] - 0.3), 1 - np.abs(u[None, :] - 0.3))
    dist = np.hypot(du * 2 * np.pi * np.sin(np.pi * 0.3), (v[:, None] - 0.3)
                    * np.pi)
    sky[dist < 0.0045] = 4000.0
    return sky.astype(np.float32)


def _textures(size=TEXTURE_SIZE):
    """The torus grid's two images: an RGBA base colour (a checker of two
    tints under noise, alpha below the MASK cutoff in a lattice of holes)
    and a metallic-roughness image (roughness in G, metallic stripes in
    B), seeded."""
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:size, 0:size]
    checker = ((xx // 64 + yy // 64) % 2)[..., None]
    base = np.where(checker, [200, 120, 60], [60, 140, 210]) + rng.normal(
        0, 12, (size, size, 3))
    alpha = np.where(((xx % 128) < 24) & ((yy % 128) < 24), 40, 255)
    base = np.concatenate([base, alpha[..., None]], -1)
    mr = np.stack([np.zeros_like(xx), 40 + 180 * (xx / size),
                   np.where((yy // 96) % 3 == 0, 255, 0)], -1)
    return (np.clip(base, 0, 255).astype(np.uint8),
            np.clip(mr, 0, 255).astype(np.uint8))


def _write_bridge_obj(path, device):
    """TEST_SCENES[BRIDGE_SCENE]'s soup as OBJ + MTL: v / vt / vn per
    corner, one usemtl group per material, Kd / Ns / illum / d from its
    materials → (the soup, its materials per triangle)."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES
    from bifrost3d_tpu_torch.math.octahedral import octahedral_decode
    from torch_scene_files import write_obj
    scene, _ = TEST_SCENES[BRIDGE_SCENE](device=device)
    tris = scene.tri_verts.cpu().numpy()
    mat = scene.materials
    materials = [dict(
        name=f"bridge{i}", Kd=tuple(mat.tint[i].tolist()),
        Ns=2.0 / float(mat.roughness[i]) ** 4 - 2.0,
        illum=3 if float(mat.metallic[i]) > 0.5 else 2, d=1.0)
        for i in range(int(mat.tint.shape[0]))]
    tri_material = scene.tri_material.cpu().numpy()
    write_obj(path, tris, tri_material, materials,
              tri_normals=octahedral_decode(scene.tri_normals_oct).cpu()
              .numpy(), tri_uvs=scene.tri_uvs.cpu().numpy())
    return tris, tri_material


def _files_f1(device, card, paths) -> dict:
    """F1: bridge.obj (49,678 triangles) through the native tokenizer and
    the viewer, the megakernel's BVH branch (B3)."""
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io import obj as tobj
    obj = paths["obj"]
    tris, tri_material = _write_bridge_obj(obj, device)
    t0 = time.perf_counter()
    meshes, mats = tobj.load_obj(obj, use_native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_meshes, py_mats = tobj.load_obj(obj, use_native=False)
    python_s = time.perf_counter() - t0
    check(py_mats == mats and all(
        np.array_equal(getattr(a[0], f), getattr(b[0], f))
        for a, b in zip(meshes, py_meshes)
        for f in ("indices", "positions", "normals", "texcoords")),
        "F1: the native and the Python tokenizer disagree")
    order = np.concatenate([np.nonzero(tri_material == k)[0]
                            for k in range(len(mats))])
    loaded = np.concatenate([m.positions.reshape(-1, 3, 3)
                             for m, _, _ in meshes])
    check(np.array_equal(loaded, tris[order]),
          "F1: the loaded triangles are not those written")

    png = os.path.join(FILES_DIR, "bridge.png")
    run = _viewer(["--scene", obj, "-n", str(ACCUMULATIONS), "-o", png],
                  {"B2_B3": ACCUMULATIONS}, "F1 viewer")
    scene, cam = simple_viewer.build_scene_from_file(obj, None,
                                                     (0.68, 0.92, 1.0),
                                                     device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    path = _expect_megakernel(scene, settings, "F1 bridge.obj")
    _, img, rays = _kernel_frame(scene, cam, RES, 1, settings)
    _, ref, ref_rays = _plain_frame(scene, cam, RES, 1, settings)
    flips, max_err, mean_rel = _gate(img, ref, "F1: kernel vs plain",
                                     KERNEL_FLIPS, KERNEL_MEAN)
    out = dict(launches=run["counts"]["B2_B3"], native_s=native_s,
               python_s=python_s, flips=flips, scene=(scene, cam),
               tris=len(tris))
    print(f"files/F1 bridge.obj: {len(tris)} triangles, "
          f"{os.path.getsize(obj) / 2**20:.1f} MiB | load: native tokenizer "
          f"{native_s:.3f} s, Python tokenizer {python_s:.3f} s, the "
          f"triangles those written | viewer -n {ACCUMULATIONS} {RES}x{RES}: "
          f"{path}, launches {run['counts']} | {RES}² kernel vs plain "
          f"{flips:.5f} flips, max |d| {max_err:.3g}, means {mean_rel:.2e} "
          f"apart | {card}", flush=True)
    return out


def _files_f2(device, card, paths) -> dict:
    """F2: torus.glb (589,824 triangles, two 1024² PNG textures, MASK)
    through the viewer, the pooled wavefront on the BVH trace (B4)."""
    import warnings
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.apps.scenes import torus_grid_mesh
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io import gltf as tgltf
    from torch_scene_files import write_textured_glb
    glb = paths["glb"]
    mesh = torus_grid_mesh()
    base, mr = _textures()
    write_textured_glb(glb, mesh, base, mr, alpha_mode="MASK")
    doc, buffers = tgltf._load_glb(glb)
    t0 = time.perf_counter()
    arrays = [tgltf._read_accessor(doc, buffers, i)
              for i in range(len(doc["accessors"]))]
    accessor_s = time.perf_counter() - t0
    check(np.array_equal(arrays[0], mesh.positions) and np.array_equal(
        arrays[2], mesh.texcoords), "F2: the strided accessors read back "
        "other values")
    t0 = time.perf_counter()
    images = [tgltf._load_gltf_image(doc, buffers, i, FILES_DIR)
              for i in range(2)]
    png_s = time.perf_counter() - t0
    check(np.array_equal((images[0] * 255 + 0.5).astype(np.uint8), base)
          and np.array_equal((images[1] * 255 + 0.5).astype(np.uint8), mr),
          "F2: the decoded PNGs are not the images written")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        tgltf.load_gltf(glb)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene, cam = simple_viewer.build_scene_from_file(
            glb, None, (0.68, 0.92, 1.0), device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    gltf_warnings = [str(w.message) for w in caught if "glTF" in str(
        w.message)]
    check(not gltf_warnings, f"F2: glTF warnings {gltf_warnings}")
    check(scene.textures.count == 3, f"F2: {scene.textures.count} textures "
          "in the bank, not tint-roughness, metallic and coverage")
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    path = pt.explain_render_path(scene, settings)
    check(path.startswith("wavefront [BVH trace"), f"F2: {path}")

    png = os.path.join(FILES_DIR, "torus.png")
    run = _viewer(["--scene", glb, "-n", str(GLTF_ACCUMULATIONS), "-o", png],
                  {"B4": "> 0"}, "F2 viewer")
    small = FILES_GATE_RES
    kern = pt.render_sample_fast(scene, cam, small, small, 1, settings)
    with mock.patch.object(hier, "hierarchical_intersect",
                           hier.hierarchical_intersect_reference):
        plain = pt.render_sample_fast(scene, cam, small, small, 1, settings)
    flips, max_err, mean_rel = _gate(kern, plain, "F2: kernel vs plain trace")
    frames = _timed_frames(scene, cam, RES, settings, GLTF_ACCUMULATIONS)
    out = dict(launches=run["counts"]["B4"], accessor_s=accessor_s,
               png_s=png_s, load_s=load_s, build_s=build_s,
               viewer_s=run["seconds"], flips=flips, frames=frames,
               scene=(scene, cam))
    print(f"files/F2 torus.glb: {mesh.indices.shape[0]} triangles, "
          f"{os.path.getsize(glb) / 2**20:.1f} MiB, interleaved stride-32 "
          f"view, two {TEXTURE_SIZE}² Paeth PNGs | load: accessors "
          f"{accessor_s:.3f} s, PNG decode {png_s:.3f} s, load_gltf "
          f"{load_s:.3f} s, build_scene_from_file (the load again, the BVH, "
          f"the packing, the bank) {build_s:.2f} s, 3 textures, "
          f"no glTF warning | viewer -n {GLTF_ACCUMULATIONS} {RES}x{RES} in "
          f"{run['seconds']:.2f} s with load and build: {path}, launches "
          f"{run['counts']} | {small}² kernel vs plain trace {flips:.5f} "
          f"flips, means {mean_rel:.2e} apart | render_sample_fast frame "
          f"{frames['ms']:.1f} ms (median of 3, {frames['ms_min']:.1f}–"
          f"{frames['ms_max']:.1f}), launches a frame {frames['per_frame']} | "
          f"{card}", flush=True)
    return out


def _files_f3(device, card, paths) -> dict:
    """F3: a 1024 × 512 EXR sky as --environment-map on CornellBox and on
    bridge.obj: the pooled wavefront on the dense trace (B1)."""
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io import image as timage
    exr = paths["sky"]
    sky = _sky()
    timage.save_exr(exr, sky)
    t0 = time.perf_counter()
    back = timage.load_image(exr)
    exr_s = time.perf_counter() - t0
    check(np.array_equal(back.view(np.uint32), sky.view(np.uint32)),
          "F3: the EXR does not read back bit for bit")
    out = dict(exr_s=exr_s, launches=0)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    for name, scene_arg in (("CornellBox", "CornellBox"),
                            ("bridge.obj", paths["obj"])):
        png = os.path.join(FILES_DIR, f"env_{name.split('.')[0]}.png")
        run = _viewer(["--scene", scene_arg, "--environment-map", exr, "-n",
                       str(ENV_ACCUMULATIONS), "-o", png], {"B1": "> 0"},
                      f"F3 viewer {name}")
        scene, cam = simple_viewer.viewer_scene(
            scene_arg, back, (0.68, 0.92, 1.0), RES, RES, device=device)
        path = pt.explain_render_path(scene, settings)
        check(path.startswith("wavefront") and "environment" in path,
              f"F3 {name}: {path}")
        small = FILES_GATE_RES
        kern = pt.render_sample_fast(scene, cam, small, small, 1, settings)
        with mock.patch.object(dense, "pallas_intersect",
                               dense.dense_intersect_reference):
            plain = pt.render_sample_fast(scene, cam, small, small, 1,
                                          settings)
        flips, max_err, mean_rel = _gate(kern, plain,
                                         f"F3 {name}: kernel vs plain trace")
        frames = _timed_frames(scene, cam, RES, settings, ENV_ACCUMULATIONS)
        out["launches"] += run["counts"]["B1"]
        out[name] = dict(launches=run["counts"]["B1"], flips=flips,
                         frames=frames, viewer_s=run["seconds"])
        print(f"files/F3 {name} + sky.exr ({SKY_W}x{SKY_H}, read in "
              f"{exr_s:.3f} s, bit for bit): viewer -n {ENV_ACCUMULATIONS} "
              f"{RES}x{RES} in {run['seconds']:.2f} s: {path}, launches "
              f"{run['counts']} | {small}² kernel vs plain trace "
              f"{flips:.5f} flips, means {mean_rel:.2e} apart | "
              f"render_sample_fast frame {frames['ms']:.1f} ms (median of 3, "
              f"{frames['ms_min']:.1f}–{frames['ms_max']:.1f}), launches a "
              f"frame {frames['per_frame']} | {card}", flush=True)
    return out


def _files_f4(device, card, paths, scenes) -> dict:
    """F4: the six AOVs at 512² on bridge.obj (B1) and torus.glb (B4), one
    closest-hit launch each, against the plain trace; the viewer's --aov
    for each on bridge.obj and one on torus.glb, written as EXR."""
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.geometry.traverse import intersect_scene
    from bifrost3d_tpu_torch.integrator.aov import render_aovs
    from bifrost3d_tpu_torch.io import image as timage
    from bifrost3d_tpu_torch.scene.camera import camera_rays
    out = {}
    cases = (("bridge.obj", "B1", dense, "pallas_intersect",
              dense.dense_intersect_reference),
             ("torus.glb", "B4", hier, "hierarchical_intersect",
              hier.hierarchical_intersect_reference))
    for (name, kernel, module, attr, reference), (scene, cam) in zip(
            cases, scenes):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        aovs = render_aovs(scene, cam, RES, RES)
        torch.cuda.synchronize()
        aov_ms = (time.perf_counter() - t0) * 1e3
        counts = _trace_counts()
        check(counts[kernel] == 1 and sum(counts.values()) == 1,
              f"F4 {name}: launches {counts}, expected one of {kernel}")
        o, d = (x.reshape(-1, 3) for x in camera_rays(cam, RES, RES))
        hit = intersect_scene(scene.bvh, scene.tri_verts, o, d,
                              t_min=scene.scene_epsilon,
                              tri_components=scene.tri_components,
                              tri_clustered=scene.tri_clustered)
        with mock.patch.object(module, attr, reference):
            plain = render_aovs(scene, cam, RES, RES)
            ref = intersect_scene(scene.bvh, scene.tri_verts, o, d,
                                  t_min=scene.scene_epsilon,
                                  tri_components=scene.tri_components,
                                  tri_clustered=scene.tri_clustered)
        failures = []
        agree, ties, t_err = _compare_hits(hit, ref, f"F4 {name}", failures)
        uv_share, uv_err = _compare_uv(hit, ref, f"F4 {name}", failures)
        same = ((hit.prim == ref.prim) & (ref.prim >= 0)).reshape(RES, RES)
        for key in ("tint", "roughness", "primitive_id"):
            if not bool(torch.equal(aovs[key][same], plain[key][same])):
                failures.append(f"F4 {name}: {key} differs where prim "
                                "agrees")
        t_ref = ref.t.reshape(RES, RES)[same]
        d_err = (aovs["depth"][same] - plain["depth"][same]).abs()
        if not bool((d_err <= 1e-5 * t_ref / (100.0 - 0.1) + 1e-7).all()):
            failures.append(f"F4 {name}: depth beyond the t gate")
        shares = {}
        for key in ("shading_normal", "albedo"):
            err = (aovs[key][same] - plain[key][same]).abs().amax(-1)
            shares[key] = (float((err <= 1e-3).float().mean()),
                           float(err.max()))
            if shares[key][0] < 0.999:
                failures.append(f"F4 {name}: {key} within 1e-3 on "
                                f"{shares[key][0]:.5f} of the hits")
        check(not failures, "; ".join(failures))
        names = simple_viewer.AOVS if kernel == "B1" else ("primitive_id",)
        scene_arg = paths["obj"] if kernel == "B1" else paths["glb"]
        for aov in names:
            exr = os.path.join(FILES_DIR, f"aov_{aov}_{kernel}.exr")
            _viewer(["--scene", scene_arg, "--aov", aov, "-o", exr],
                    {kernel: 1}, f"F4 viewer --aov {aov} {name}")
            check(np.array_equal(timage.load_exr(exr),
                                 simple_viewer.aov_image(aovs, aov)),
                  f"F4 {name}: the viewer's {aov} EXR is not the AOV")
        out[name] = dict(launches=1, aov_ms=aov_ms, agree=agree, ties=ties,
                         t_err=t_err, uv_share=uv_share, uv_err=uv_err,
                         shares=shares)
        print(f"files/F4 {name}: render_aovs {RES}x{RES} in {aov_ms:.2f} ms, "
              f"{kernel} launches 1 | vs the plain trace: prim agrees off "
              f"ties {agree:.5f} ({ties} ties), max |dt| {t_err:.3g}, u, v "
              f"within 1e-3 on {uv_share:.5f} (max {uv_err:.3g}); tint, "
              f"roughness, primitive_id equal and depth within the t gate "
              f"where prim agrees; shading normal within 1e-3 on "
              f"{shares['shading_normal'][0]:.5f} (max "
              f"{shares['shading_normal'][1]:.3g}), albedo on "
              f"{shares['albedo'][0]:.5f} (max {shares['albedo'][1]:.3g}) | "
              f"viewer --aov {', '.join(names)} -o .exr read back equal | "
              f"{card}", flush=True)
    return out


def files_phase(device, card) -> dict:
    """Phase 22: the viewer on files written here from seeded numpy (the
    repository holds no model files): F1 an OBJ on B3, F2 a textured GLB on
    B4, F3 an EXR environment map on B1, F4 the AOVs on B1 and B4."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    os.makedirs(FILES_DIR, exist_ok=True)
    paths = {"obj": os.path.join(FILES_DIR, "bridge.obj"),
             "glb": os.path.join(FILES_DIR, "torus.glb"),
             "sky": os.path.join(FILES_DIR, "sky.exr")}
    f1 = _files_f1(device, card, paths)
    f2 = _files_f2(device, card, paths)
    f3 = _files_f3(device, card, paths)
    f4 = _files_f4(device, card, paths, (f1.pop("scene"), f2.pop("scene")))
    return dict(F1=f1, F2=f2, F3=f3, F4=f4)


# -- phase 23: every viewer mode -------------------------------------------------

MODES_DIR = os.path.join(REPO, "build", "modes")
MODES_GATE_RES = 64
REG_ACCUMULATIONS = 2
DENOISE_ACCUMULATIONS = 8
# Preview scenes: name, whether a viewer scene (SCENES) or a TEST_SCENES one.
PREVIEW_SCENES = (("CornellBox", True), ("Sphere", True), ("Opacity", True),
                  (BRIDGE_SCENE, False), ("torus_grid", False))
# Preview card vs CPU at 64²: share of pixels off by > 1e-3 without SSAO
# (pixels where the kernel's trace and its plain version part at a triangle
# edge: 0.44% of CornellBox's AOV pixels at 64²) and with it (the AO pass
# reads those pixels' positions through taps up to 16 pixels away, and its
# 9-tap cross blur spreads each over its row and column); the means within
# 0.5%.
PREVIEW_FLIPS, PREVIEW_SSAO_FLIPS, PREVIEW_MEAN = 0.01, 0.05, 0.005
FLOOR_TEXTURE = 1024
CONVOLUTION_LEVELS = "0.0,0.25,0.5,0.75,1.0"
POST_FRAMES = 8


def _viewer_said(argv, expect, what) -> dict:
    """:func:`_viewer` with the viewer's standard output kept (and
    printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = _viewer(argv, expect, what)
    print(buf.getvalue(), end="", flush=True)
    return dict(run, said=buf.getvalue())


def _trace_kernel(scene) -> str:
    """The trace kernel ``intersect_scene`` launches for the scene's
    packing: B1 (dense table), B4 (BVH), B6 or B7."""
    kind = type(scene.tri_clustered).__name__
    return {"HierTriangles": "B4", "ClusteredTriangles": "B6",
            "VmemTriangles": "B7"}.get(kind, "B1")


def _frame_ms(fn, n=3) -> dict:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(ms=statistics.median(times), ms_min=min(times),
                ms_max=max(times))


def _modes_v1(device, card) -> dict:
    """V1: path regularization through the viewer: the pooled wavefront on
    B1 ("path regularization" is the megakernel's reason)."""
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    scene, cam = create_cornell_box(device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES,
                                 path_regularization_scale=1.0)
    path = pt.explain_render_path(scene, settings)
    check("path regularization" in path, f"V1: {path}")
    run = _viewer_said(["--scene", "CornellBox", "--path-regularization",
                        "1.0", "-n", str(REG_ACCUMULATIONS), "-o",
                        os.path.join(MODES_DIR, "regularized.png")],
                       {"B1": "> 0"}, "V1 viewer --path-regularization")
    frames = _timed_frames(scene, cam, RES, settings, REG_ACCUMULATIONS, n=1)
    cpu_scene, cpu_cam = create_cornell_box(device=torch.device("cpu"))
    small, gates = MODES_GATE_RES, {}
    for decay in (0.0, 0.5):
        s = settings._replace(path_regularization_decay=decay)
        img = pt.render_sample_fast(scene, cam, small, small, 3, s)
        ref = pt.render_sample_fast(cpu_scene, cpu_cam, small, small, 3, s)
        gates[decay] = _gate(img.reshape(-1, 3).cpu(), ref.reshape(-1, 3),
                             f"V1 decay {decay}: card vs cpu")
    out = dict(launches=run["counts"]["B1"], frames=frames, gates=gates,
               viewer_s=run["seconds"])
    print(f"viewer_modes/V1 path regularization: viewer --scene CornellBox "
          f"--path-regularization 1.0 -n {REG_ACCUMULATIONS} {RES}x{RES} in "
          f"{run['seconds']:.2f} s: {path}, launches {run['counts']} | "
          f"render_sample_fast frame {frames['ms']:.1f} ms, launches a frame "
          f"{frames['per_frame']} | {small}² card vs cpu: decay 0 "
          f"{gates[0.0][0]:.5f} flips, means {gates[0.0][2]:.2e} apart; "
          f"decay 0.5 {gates[0.5][0]:.5f} flips, means {gates[0.5][2]:.2e} "
          f"apart | {card}", flush=True)
    return out


def _checker_floor(device, size):
    """tests/test_textures.py's distant checkered floor with the port's
    API: a 200-unit plane, a directional light and a size² trilinear
    checker."""
    from bifrost3d_tpu_torch.geometry.creation import make_plane
    from bifrost3d_tpu_torch.io.texture import FILTER_TRILINEAR, TextureBank
    from bifrost3d_tpu_torch.lights.types import LIGHT_DIRECTIONAL, LightArray
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    from bifrost3d_tpu_torch.scene.materials import MaterialArray
    from bifrost3d_tpu_torch.scene.render_scene import build_render_scene
    c = (np.indices((size, size)).sum(axis=0) % 2).astype(np.float32)
    bank = TextureBank.build([dict(image=np.stack([c, c, c], -1),
                                   filter=FILTER_TRILINEAR)], device=device)
    mats = MaterialArray.build([dict(tint=(1, 1, 1), roughness=1.0,
                                     tint_roughness_texture=0)],
                               device=device)
    lights = LightArray.build([
        {"kind": LIGHT_DIRECTIONAL, "direction": (0, -1, 0.2),
         "radiance": (3.0, 3.0, 3.0)}], device=device)
    scene = build_render_scene([(make_plane(size=200.0), 0, None)], mats,
                               lights, textures=bank, device=device)
    cam = perspective_camera(eye=(0, 1.0, 0), target=(0, 0.0, 30.0),
                             device=device)
    return scene, cam


def _row_spread(img, level0):
    """Within-row spread of the band just below the horizon (the aliasing
    measure of tests/test_textures.py)."""
    horizon = next(i for i in range(img.shape[0])
                   if float(level0[i].mean()) > 1e-4)
    rows = slice(horizon + 1, horizon + 7)
    return (float(img[rows].mean(-1).std(1).mean()),
            float(level0[rows].mean(-1).std(1).mean()))


def _modes_v2(device, card) -> dict:
    """V2: trilinear mips on the distant floor, the pooled wavefront on
    B1."""
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    scene, cam = _checker_floor(device, FLOOR_TEXTURE)
    out = {}
    for bounces in (0, BOUNCES):
        settings = pt.settings_for_scene(scene, max_bounce_count=bounces,
                                         next_event_sample_count=1)
        check(settings.trilinear_textures, "V2: no trilinear hint")
        path = pt.explain_render_path(scene, settings)
        check(path.startswith("wavefront") and "non-nearest texture "
              "filtering" in path, f"V2: {path}")
        pt.render_sample_fast(scene, cam, RES, RES, 0, settings)
        frames = _timed_frames(scene, cam, RES, settings, 1, n=2)
        check(set(frames["per_frame"]) == {"B1"},
              f"V2: launches a frame {frames['per_frame']}, expected B1 only")
        out[bounces] = dict(frames=frames, path=path)
    settings = pt.settings_for_scene(scene, max_bounce_count=0,
                                     next_event_sample_count=1)
    cpu_scene, cpu_cam = _checker_floor(torch.device("cpu"), FLOOR_TEXTURE)
    small = MODES_GATE_RES
    img = pt.render_sample_fast(scene, cam, small, small, 0, settings)
    ref = pt.render_sample_fast(cpu_scene, cpu_cam, small, small, 0, settings)
    gate = _gate(img.reshape(-1, 3).cpu(), ref.reshape(-1, 3),
                 "V2: card vs cpu")
    level0 = pt.render_sample_fast(scene, cam, small, small, 0,
                                   settings._replace(trilinear_textures=False))
    tri_std, l0_std = _row_spread(img.cpu(), level0.cpu())
    check(l0_std > 2.0 * tri_std, f"V2: level 0's row spread {l0_std} is not "
          f"above twice trilinear's {tri_std}")
    out.update(gate=gate, spread=(tri_std, l0_std),
               launches=sum(round(out[b]["frames"]["per_frame"].get("B1", 0))
                            for b in (0, BOUNCES)))
    print(f"viewer_modes/V2 trilinear: 200-unit floor, {FLOOR_TEXTURE}² "
          f"trilinear checker, {RES}x{RES}: {out[0]['path']} | frame "
          f"{out[0]['frames']['ms']:.1f} ms at 0 bounces, "
          f"{out[BOUNCES]['frames']['ms']:.1f} ms at {BOUNCES}, B1 a frame "
          f"{out[0]['frames']['per_frame'].get('B1', 0):.1f} / "
          f"{out[BOUNCES]['frames']['per_frame'].get('B1', 0):.1f} | {small}² card vs"
          f" cpu {gate[0]:.5f} flips, means {gate[2]:.2e} apart | row spread "
          f"below the horizon: level 0 {l0_std:.4f}, trilinear "
          f"{tri_std:.4f} | {card}", flush=True)
    return out


def _denoise_ms(backend) -> float:
    """Median CUDA-event ms of the backend's à-trous filter alone on its
    running mean and AOVs."""
    from bifrost3d_tpu_torch.integrator.backend import atrous_denoise
    args = (backend.buffer, backend._aovs["shading_normal"],
            backend._aovs["albedo"], backend.denoise_iterations)
    return _median_ms(lambda: atrous_denoise(*args), repeats=5, warmup=1)


def _modes_v3(device, card) -> dict:
    """V3: the denoised backend on CornellBox (the viewer, B2) and on
    hier_bridge_15k_env (the backend, B3); one AOV trace each."""
    from bifrost3d_tpu_torch.apps.scenes import SCENES, TEST_SCENES
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.integrator.backend import (
        DenoisedBackend, atrous_denoise)
    n, out = DENOISE_ACCUMULATIONS, {}
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    for name, viewer in (("CornellBox", True),
                         ("hier_bridge_15k_env", False)):
        make = SCENES[name] if viewer else TEST_SCENES[name]
        scene, cam = make(device=device)
        trace = _trace_kernel(scene)
        expect = {"B2_B3": n, trace: 1}
        if viewer:
            run = _viewer_said(["--scene", name, "--renderer", "denoised",
                                "-n", str(n), "-o", os.path.join(
                                    MODES_DIR, f"denoised_{name}.png")],
                               expect, f"V3 viewer --renderer denoised {name}")
            counts, seconds = run["counts"], run["seconds"]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        backend = DenoisedBackend(scene, cam, RES, RES, settings)
        for _ in range(n):
            backend.render()
        torch.cuda.synchronize()
        if not viewer:
            counts, seconds = _trace_counts(), time.perf_counter() - t0
            for k, v in counts.items():
                check(v == expect.get(k, 0), f"V3 {name}: launches {counts}, "
                      f"expected {expect}")
        denoise = _denoise_ms(backend)
        backend.accumulations = 15          # the next frame, 16, denoises
        render = _frame_ms(backend.render, n=1)["ms"]
        out[name] = dict(counts=counts, seconds=seconds, denoise_ms=denoise,
                         render_ms=render, trace=trace)
    # 64² on the card against the CPU: the AOVs, the running mean, and the
    # denoised image against the CPU's filter on the card's own inputs.
    small = MODES_GATE_RES
    scene, cam = SCENES["CornellBox"](device=device)
    cpu_scene, cpu_cam = SCENES["CornellBox"](device=torch.device("cpu"))
    card_b = DenoisedBackend(scene, cam, small, small, settings)
    cpu_b = DenoisedBackend(cpu_scene, cpu_cam, small, small, settings)
    for _ in range(2):
        img = card_b.render()
        cpu_b.render()
    aov_share = {}
    for key in ("albedo", "shading_normal", "depth"):
        a, b = card_b._aovs[key].cpu(), cpu_b._aovs[key]
        d = (a - b).abs()
        d = d.amax(-1) if d.dim() == 3 else d
        aov_share[key] = float((d <= 1e-3).float().mean())
        check(aov_share[key] >= 0.995, f"V3 AOV {key}: equal within 1e-3 on "
              f"{aov_share[key]:.5f} of the pixels")
    mean_gate = _gate(card_b.buffer.reshape(-1, 3).cpu(),
                      cpu_b.buffer.reshape(-1, 3), "V3 running mean")
    ref = atrous_denoise(card_b.buffer.cpu(),
                         card_b._aovs["shading_normal"].cpu(),
                         card_b._aovs["albedo"].cpu())
    err = float((img.cpu() - ref).abs().max())
    check(err <= 1e-4, f"V3: the card's denoise is {err} off the CPU's")
    out.update(aov_share=aov_share, mean_gate=mean_gate, denoise_err=err)
    for name in ("CornellBox", "hier_bridge_15k_env"):
        d = out[name]
        print(f"viewer_modes/V3 denoised {name}: {RES}x{RES} -n {n} in "
              f"{d['seconds']:.2f} s, launches {d['counts']} (the AOV trace "
              f"{d['trace']}) | à-trous alone {d['denoise_ms']:.2f} ms "
              f"(CUDA events, 4 iterations), a denoised render() "
              f"{d['render_ms']:.2f} ms | {card}", flush=True)
    print(f"viewer_modes/V3 gate {small}²: AOVs equal within 1e-3 on "
          f"{aov_share} | running mean card vs cpu {mean_gate[0]:.5f} flips |"
          f" denoised image vs the CPU's filter on the card's inputs max "
          f"|d| {err:.3g}", flush=True)
    return out


def _modes_v4(device, card) -> dict:
    """V4: the preview renderer: a layer's primary trace and each light's
    shadow trace launch the scene's trace kernel."""
    from bifrost3d_tpu_torch.apps import scenes
    from bifrost3d_tpu_torch.preview import render_preview
    out = {}
    cpu = torch.device("cpu")
    for name, viewer in PREVIEW_SCENES:
        make = scenes.SCENES[name] if viewer else scenes.TEST_SCENES[name]
        scene, cam = make(device=device)
        layers = 4 if bool(torch.any(scene.materials.coverage < 1.0)) else 1
        trace = _trace_kernel(scene)
        per_frame = layers * (1 + scene.lights.count)
        if viewer:
            run = _viewer_said(["--scene", name, "--renderer", "preview", "-o",
                                os.path.join(MODES_DIR, f"preview_{name}.png")],
                               {trace: per_frame},
                               f"V4 viewer --renderer preview {name}")
        else:
            torch.cuda.synchronize()
            _reset_counts()
            render_preview(scene, cam, RES, RES)
            torch.cuda.synchronize()
            counts = _trace_counts()
            for k, v in counts.items():
                check(v == (per_frame if k == trace else 0),
                      f"V4 {name}: launches {counts}, expected {per_frame} "
                      f"of {trace}")
        frames = _frame_ms(lambda: render_preview(scene, cam, RES, RES))
        small = MODES_GATE_RES
        cpu_scene, cpu_cam = make(device=cpu)
        gate = {}
        for ssao, budget in ((False, PREVIEW_FLIPS),
                             (True, PREVIEW_SSAO_FLIPS)):
            img = render_preview(scene, cam, small, small, enable_ssao=ssao)
            ref = render_preview(cpu_scene, cpu_cam, small, small,
                                 enable_ssao=ssao)
            gate[ssao] = _gate(img.reshape(-1, 3).cpu(), ref.reshape(-1, 3),
                               f"V4 {name} (SSAO {ssao}): card vs cpu",
                               budget, PREVIEW_MEAN)
        out[name] = dict(launches=per_frame, trace=trace, layers=layers,
                         frames=frames, gate=gate,
                         tris=int(scene.tri_verts.shape[0]))
        print(f"viewer_modes/V4 preview {name}: {out[name]['tris']} "
              f"triangles, {layers} layer(s), {scene.lights.count} light(s) | "
              f"{trace} launches a {RES}x{RES} frame {per_frame} = layers × "
              f"(1 + lights), no other kernel | frame {frames['ms']:.2f} ms "
              f"(median of 3, {frames['ms_min']:.2f}–{frames['ms_max']:.2f}) |"
              f" {small}² card vs cpu, pixels off by > 1e-3: SSAO off "
              f"{gate[False][0]:.5f} (budget {PREVIEW_FLIPS}), on "
              f"{gate[True][0]:.5f} (budget {PREVIEW_SSAO_FLIPS}), means "
              f"{gate[True][2]:.2e} apart | {card}", flush=True)
    return out


def _modes_v5(device, card) -> dict:
    """V5: checkpoint/resume: -n 8 every 4, then -n 12 from the same
    directory, against an uninterrupted -n 12, bit for bit."""
    import shutil
    from bifrost3d_tpu_torch.io.image import load_exr
    ckpt = os.path.join(MODES_DIR, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--scene", "CornellBox", "--checkpoint-dir", ckpt,
            "--checkpoint-every", "4"]
    first = _viewer_said(base + ["-n", "8", "-o", os.path.join(
        MODES_DIR, "ckpt_8.exr")], {"B2_B3": 8}, "V5 -n 8")
    check(sorted(os.listdir(ckpt)) == ["ckpt_4.npz", "ckpt_8.npz"],
          f"V5: checkpoints {sorted(os.listdir(ckpt))}")
    resumed = _viewer_said(base + ["-n", "12", "-o", os.path.join(
        MODES_DIR, "resumed_12.exr")], {"B2_B3": 4}, "V5 -n 12 resumed")
    check("resumed at accumulation 8" in resumed["said"],
          f"V5: the second run said {resumed['said']!r}")
    _viewer_said(["--scene", "CornellBox", "-n", "12", "-o",
                  os.path.join(MODES_DIR, "whole_12.exr")],
                 {"B2_B3": 12}, "V5 -n 12 uninterrupted")
    a = load_exr(os.path.join(MODES_DIR, "resumed_12.exr"))
    b = load_exr(os.path.join(MODES_DIR, "whole_12.exr"))
    equal = bool(np.array_equal(a.view(np.uint32), b.view(np.uint32)))
    check(equal, f"V5: the resumed image is off the uninterrupted one by "
          f"{float(np.abs(a - b).max())}")
    print(f"viewer_modes/V5 checkpoint: -n 8 every 4, then -n 12 resumed at "
          f"accumulation 8 (4 megakernel launches), uninterrupted -n 12 | "
          f"resumed image bit for bit the uninterrupted one: {equal} | "
          f"{card}", flush=True)
    return dict(launches=first["counts"]["B2_B3"]
                + resumed["counts"]["B2_B3"], equal=equal)


def _modes_v6(device, card) -> dict:
    """V6: the EnvironmentConvolution app on the 1024 × 512 EXR sky, each
    level against the CPU's on a 64 × 32 sky; dual-kawase bloom and
    process_stateful over 8 frames of a 512² HDR frame."""
    from bifrost3d_tpu_torch.apps import environment_convolution
    from bifrost3d_tpu_torch.io.image import save_exr
    from bifrost3d_tpu_torch.post.pipeline import process_stateful
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
    from bifrost3d_tpu_torch.preview.ibl import convolve_environment
    exr = os.path.join(MODES_DIR, "sky.exr")
    save_exr(exr, _sky())
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    environment_convolution.main([exr, "--roughness", CONVOLUTION_LEVELS,
                                  "--output-dir", os.path.join(MODES_DIR,
                                                               "ibl")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(sum(_trace_counts().values()) == 0, "V6: a kernel launched")
    levels = [float(r) for r in CONVOLUTION_LEVELS.split(",")]
    small = torch.tensor(_sky(64, 32))
    card_mips = convolve_environment(small.to(device), levels, samples=256)
    cpu_mips = convolve_environment(small, levels, samples=256)
    gates = []
    for (r, a), (_, b) in zip(card_mips, cpu_mips):
        d = ((a.cpu() - b).abs() / b.abs().clamp_min(1e-3)).amax(-1)
        gates.append((r, float((d > 1e-3).float().mean()), float(d.max())))
        check(gates[-1][1] <= 0.01, f"V6 level {r}: {gates[-1][1]:.4f} of "
              "texels off the CPU's by > 1e-3 relative")

    rng = np.random.default_rng(23)
    hdr = np.exp(rng.normal(-1.0, 1.2, (RES, RES, 3))).astype(np.float32)
    hdr[200:210, 300:310] = 60.0
    settings = CameraEffectsSettings.preset()._replace(
        bloom_mode=1, bloom_threshold=2.0)
    frames = [torch.tensor(hdr * s) for s in
              np.linspace(0.5, 2.0, POST_FRAMES, dtype=np.float32)]
    card_frames = [f.to(device) for f in frames]
    prev_card, prev_cpu, times, worst = -1.0, -1.0, [], 0.0
    for i, (f_card, f_cpu) in enumerate(zip(card_frames, frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ldr, prev_card = process_stateful(f_card, settings, i, prev_card,
                                          1.0 / 30)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ref, prev_cpu = process_stateful(f_cpu, settings, i, prev_cpu,
                                         1.0 / 30)
        worst = max(worst, float((ldr.cpu() - ref).abs().max()),
                    abs(float(prev_card) - float(prev_cpu))
                    / float(prev_cpu))
    check(worst <= 1e-5, f"V6: process_stateful card vs cpu {worst}")
    post_ms = statistics.median(times)
    print(f"viewer_modes/V6 environment_convolution: {SKY_W}x{SKY_H} EXR, "
          f"{len(levels)} levels, 256 samples in {seconds:.2f} s with the "
          f"writes, no kernel | 64x32 card vs cpu per level (share of texels "
          f"off by > 1e-3 relative, max): "
          + ", ".join(f"{r:.2f}: {s:.4f} ({m:.2g})" for r, s, m in gates)
          + f" | dual-kawase bloom + process_stateful {RES}² x{POST_FRAMES}: "
          f"{post_ms:.2f} ms a frame (median), card vs cpu max |d| "
          f"{worst:.2e} | {card}", flush=True)
    return dict(seconds=seconds, gates=gates, post_ms=post_ms, post_err=worst)


def viewer_modes_phase(device, card) -> dict:
    """Phase 23: every mode of the viewer on the card at its defaults
    (512², 4 bounces, accumulations cut): V1 path regularization, V2
    trilinear mips, V3 the denoised backend, V4 the preview renderer, V5
    checkpoint/resume, V6 the EnvironmentConvolution app and the stateful
    post chain."""
    os.makedirs(MODES_DIR, exist_ok=True)
    t0 = time.perf_counter()
    out = dict(V1=_modes_v1(device, card), V2=_modes_v2(device, card),
               V3=_modes_v3(device, card), V4=_modes_v4(device, card),
               V5=_modes_v5(device, card), V6=_modes_v6(device, card))
    print(f"viewer_modes: V1–V6 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


ENGINE_DIR = os.path.join(REPO, "build", "engine")
ENGINE_BOUNCES = 3        # the interactive viewer's default --max-bounce
ENGINE_TICKS = 8
ENGINE_EDIT_TICKS = 2
ENGINE_GATE_RES = 64
ENGINE_SKY = (32, 64)     # a map the megakernel takes, but for its pool


class _EngineRig:
    """The interactive viewer's compositor on one of its datamodel scenes
    (``apps/interactive_viewer.build_scene``) with the app's three
    renderers, wired into an engine by ``Compositor.attach``; every tick's
    sync, render and post stages timed by ``utils/profiling`` (each stage
    waits for its device work)."""

    def __init__(self, device, scene_name, res):
        from bifrost3d_tpu_torch.apps import interactive_viewer as iv
        from bifrost3d_tpu_torch.core import Engine
        from bifrost3d_tpu_torch.core import compositor
        from bifrost3d_tpu_torch.integrator import path_tracer as pt
        from bifrost3d_tpu_torch.integrator.backend import (
            DenoisedBackend, SimpleBackend)
        from bifrost3d_tpu_torch.preview.renderer import PreviewBackend
        from bifrost3d_tpu_torch.utils.profiling import StageTimings
        self.data, self.cam = iv.build_scene(scene_name)
        self.comp = compositor.Compositor(self.data, res, res, device=device)
        self.settings = pt.RenderSettings(max_bounce_count=ENGINE_BOUNCES)
        self.timings = StageTimings()

        def timed(name, fn):
            def call(*args, **kwargs):
                out = []
                with self.timings.scope(name, out):
                    out.append(fn(*args, **kwargs))
                return out[0]
            return call

        def factory(make):
            def build(scene, camera, w, h):
                backend = make(scene, camera, w, h)
                backend.render = timed("render", backend.render)
                return backend
            return build

        s = self.settings
        self.ids = {
            "PathTracer": self.comp.add_renderer("PathTracer", factory(
                lambda *a: SimpleBackend(*a, s))),
            "Preview": self.comp.add_renderer("Preview", factory(
                lambda *a: PreviewBackend(*a, enable_ssao=False))),
            "Denoised": self.comp.add_renderer("Denoised", factory(
                lambda *a: DenoisedBackend(*a, s)))}
        self.data.cameras.set_renderer(self.cam, self.ids["PathTracer"])
        self.comp.sync.handle_updates = timed("sync",
                                              self.comp.sync.handle_updates)
        self._post = mock.patch.object(
            compositor, "process_stateful",
            timed("post", compositor.process_stateful))
        self.engine = Engine()
        self.comp.attach(self.engine)

    def tick(self) -> dict:
        """One engine tick → its ms (host clock to a synchronise) and each
        stage's."""
        self.timings.reset()
        torch.cuda.synchronize()
        with self._post:
            t0 = time.perf_counter()
            self.engine.do_tick(1.0 / 60)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return dict(ms=ms, **{k: v[0] * 1e3 for k, v in
                              self.timings.timings().items()})

    def backend(self, cam=None):
        cam = self.cam if cam is None else cam
        return self.comp._backends.get(
            (int(cam), self.data.cameras.get_renderer(cam)))

    def scene(self):
        return self.comp.sync.handle_updates()

    def pinhole(self, device):
        return self.data.cameras.to_pinhole(self.cam, device=device)


def _median_ticks(ticks, last=4) -> dict:
    keys = ("ms", "sync", "render", "post")
    return {k: statistics.median(t.get(k, 0.0) for t in ticks[-last:])
            for k in keys}


def _engine_e1(device, card) -> dict:
    """E1: Sphere through Compositor.attach(Engine), PathTracer, 8 ticks:
    exactly 8 B3 launches; B3 on the SceneSync-built scene against its
    plain version at 256²; the 8-tick HDR screenshot card vs CPU at 64²."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    rig = _EngineRig(device, "Sphere", RES)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    ticks = [rig.tick() for _ in range(ENGINE_TICKS)]
    seconds = time.perf_counter() - t0
    counts = _trace_counts()
    check(counts == dict(B1=0, B2_B3=ENGINE_TICKS, B4=0, B6=0, B7=0),
          f"E1: launches {counts} over {ENGINE_TICKS} ticks")
    scene = rig.scene()
    tris = int(scene.tri_verts.shape[0])
    path = _expect_megakernel(scene, rig.settings, "E1 Sphere")
    check(tris == 2210 and tris > mega.MAX_TRIS, f"E1: {tris} triangles")
    check(rig.backend().accumulations == ENGINE_TICKS, "E1: accumulations")
    small = SMALL_RES
    cam = rig.pinhole(device)
    _, img, _ = _kernel_frame(scene, cam, small, 3, rig.settings)
    _, ref, _ = _plain_frame(scene, cam, small, 3, rig.settings)
    kernel_gate = _gate(img, ref, "E1 B3 vs plain", KERNEL_FLIPS, KERNEL_MEAN)
    shots = []
    for where in (device, torch.device("cpu")):
        small_rig = _EngineRig(where, "Sphere", ENGINE_GATE_RES)
        small_rig.data.cameras.request_screenshot(
            small_rig.cam, content="hdr", minimum_iteration_count=ENGINE_TICKS)
        for _ in range(ENGINE_TICKS):
            small_rig.tick()
        (shot,) = small_rig.data.cameras.resolve_screenshot(small_rig.cam)
        check(shot["iterations"] == ENGINE_TICKS, "E1: screenshot iterations")
        shots.append(shot["image"].reshape(-1, 3).cpu())
    shot_gate = _gate(shots[0], shots[1], "E1 HDR screenshot card vs cpu")
    med = _median_ticks(ticks)
    print(f"engine/E1 Sphere {tris} triangles, {RES}x{RES}, "
          f"{ENGINE_BOUNCES} bounces: {path} | {ENGINE_TICKS} ticks through "
          f"Compositor.attach(Engine) in {seconds:.2f} s, launches {counts} | "
          f"tick {med['ms']:.3f} ms (median of the last 4: sync "
          f"{med['sync']:.3f}, render {med['render']:.3f}, post "
          f"{med['post']:.3f}), first tick {ticks[0]['ms']:.1f} ms | B3 vs "
          f"plain at {small}²: {kernel_gate[0]:.5f} of pixels off by > 1e-3, "
          f"max |d| {kernel_gate[1]:.3g}, means {kernel_gate[2]:.2e} apart | "
          f"{ENGINE_GATE_RES}² {ENGINE_TICKS}-tick HDR screenshot card vs cpu "
          f"{shot_gate[0]:.5f} flips, max |d| {shot_gate[1]:.3g}, means "
          f"{shot_gate[2]:.2e} apart | {card}", flush=True)
    return dict(rig=rig, launches=counts["B2_B3"], ticks=ticks, median=med,
                kernel_gate=kernel_gate, shot_gate=shot_gate)


def _sphere_node(data):
    return next(n for n in data.nodes if data.nodes.get_name(n) == "ball")


def _engine_edits(rig):
    """E2's edits, in order: (name, what it does to the datamodel)."""
    from bifrost3d_tpu_torch.geometry.creation import make_box
    from bifrost3d_tpu_torch.math.transform import transform_identity
    d = rig.data
    red = next(m for m in d.materials
               if d.materials.get_params(m)["tint"] == (0.8, 0.2, 0.15))
    light = next(iter(d.lights))
    root = next(iter(d.roots))

    def move():
        node = _sphere_node(d)
        t = d.nodes.get_global_transform(node)
        d.nodes.set_global_transform(node, t._replace(
            translation=t.translation + torch.tensor([0.35, 0.1, 0.2])))

    def add_mesh():
        node = d.nodes.create("cube", transform_identity()._replace(
            translation=torch.tensor([-1.2, -0.2, 0.4])))
        d.nodes.set_parent(node, d.roots.get_root_node(root))
        d.models.create(node, d.meshes.create("cube", make_box(size=0.5)),
                        red)

    def sky():
        h, w = ENGINE_SKY
        v = np.linspace(1.0, 0.2, h, dtype=np.float32)[:, None, None]
        return np.broadcast_to(v * np.asarray([0.6, 0.8, 1.0], np.float32),
                               (h, w, 3)).copy()

    return (("tint", lambda: d.materials.set_tint(red, (0.2, 0.75, 0.3))),
            ("light power", lambda: d.lights.set_power(light, (60, 60, 60))),
            ("node move", move),
            ("environment tint",
             lambda: d.roots.set_environment_tint(root, (0.9, 0.7, 0.5))),
            ("mesh added", add_mesh),
            ("environment map",
             lambda: d.roots.set_environment_map(root, sky())))


def _refit_against_rebuild(device, rig, failures) -> dict:
    """The refit scene against a full build of the same datamodel: the
    soups equal, the B3 walk's hits on 256² camera rays off ties, and a
    B3 frame of each under the statistical gate; the repack's ms."""
    from bifrost3d_tpu_torch.geometry.pallas_bvh import pack_hierarchical
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.scene.datamodel import SceneSync
    from bifrost3d_tpu_torch.utils.versioned import VersionedCache
    refit = rig.scene()
    rebuilt = SceneSync(rig.data, device=device).handle_updates()
    check(torch.equal(refit.tri_verts, rebuilt.tri_verts),
          "E2 refit: the soup differs from a full build's")
    check(refit.bvh.node_a is not rebuilt.bvh.node_a, "E2: no rebuild")
    small = SMALL_RES
    cam = rig.pinhole(device)
    lanes = mega.megakernel_inputs(refit, cam, small, small, 1, rig.settings)
    hits = [mega.hier_trace_probe(pack_hierarchical(s.tri_verts, s.bvh),
                                  lanes[6], lanes[7], 1e-4, float("inf"))
            for s in (refit, rebuilt)]
    agree, ties, dt = _compare_hits(hits[0], hits[1], "E2 refit vs rebuild "
                                    "hits", failures)
    _, a, _ = _kernel_frame(refit, cam, small, 1, rig.settings)
    _, b, _ = _kernel_frame(rebuilt, cam, small, 1, rig.settings)
    frame_gate = _gate(a, b, "E2 refit vs rebuild frame")
    with mock.patch.object(mega, "_PACK_CACHE", VersionedCache()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega._pack_scene(refit)
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - t0) * 1e3
    return dict(agree=agree, ties=ties, dt=dt, rays=int(lanes[6].shape[0]),
                frame_gate=frame_gate, pack_ms=pack_ms)


def _engine_e2(device, card, rig) -> dict:
    """E2: incremental edits on E1's scene, each followed by 2 ticks."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    out, failures = {}, []
    repacks = {"node move": 1, "mesh added": 1, "environment map": 0}
    for name, edit in _engine_edits(rig):
        packs, frames = mega._PACK_CACHE.stores, mega._FRAME_CACHE.stores
        before = rig.scene()
        torch.cuda.synchronize()
        _reset_counts()
        edit()
        first = rig.tick()
        restarted = rig.backend().accumulations
        rest = [rig.tick() for _ in range(ENGINE_EDIT_TICKS - 1)]
        counts = _trace_counts()
        scene = rig.scene()
        path = pt.explain_render_path(scene, rig.settings)
        stores = (mega._PACK_CACHE.stores - packs,
                  mega._FRAME_CACHE.stores - frames)
        check(scene is not before, f"E2 {name}: the scene was not synced")
        check(restarted == 1, f"E2 {name}: accumulation restarted at "
              f"{restarted}")
        check(stores[0] == repacks.get(name, 0),
              f"E2 {name}: {stores[0]} geometry packs")
        if name == "environment map":
            check(path.startswith("wavefront") and "without presampled pool"
                  in path, f"E2 {name}: {path}")
            check(counts["B1"] > 0 and counts["B2_B3"] == 0,
                  f"E2 {name}: launches {counts}")
        else:
            _expect_megakernel(scene, rig.settings, f"E2 {name}")
            check(stores[1] == 1, f"E2 {name}: {stores[1]} frame tables")
            check(counts == dict(B1=0, B2_B3=ENGINE_EDIT_TICKS, B4=0, B6=0,
                                 B7=0), f"E2 {name}: launches {counts}")
        out[name] = dict(sync_ms=first.get("sync", 0.0),
                         first_ms=first["render"], tick_ms=first["ms"],
                         later_ms=[t["ms"] for t in rest], restarted=restarted,
                         path=path, pack_stores=stores[0],
                         frame_stores=stores[1], counts=counts)
        if name == "node move":
            out[name]["refit"] = _refit_against_rebuild(device, rig, failures)
    check(not failures, "; ".join(failures))
    for name, r in out.items():
        extra = ""
        if "refit" in r:
            f = r["refit"]
            extra = (f" | refit vs full rebuild: soup equal, B3 walk's hits "
                     f"agree off ties on {f['agree']:.5f} of {f['rays']} "
                     f"camera rays ({f['ties']} ties), frame "
                     f"{f['frame_gate'][0]:.5f} flips; the repack alone "
                     f"{f['pack_ms']:.2f} ms")
        print(f"engine/E2 {name}: SceneSync {r['sync_ms']:.2f} ms, first "
              f"frame {r['first_ms']:.2f} ms (tick {r['tick_ms']:.2f}, then "
              + ", ".join(f"{ms:.2f}" for ms in r["later_ms"])
              + f" ms), accumulation restarted at {r['restarted']}, "
              f"{r['path']}, stores: _PACK_CACHE {r['pack_stores']}, "
              f"_FRAME_CACHE {r['frame_stores']}, launches {r['counts']}"
              f"{extra} | {card}", flush=True)
    return out


def _engine_e3(device, card) -> dict:
    """E3: Box with two cameras, the second at a higher z-index on
    Preview: z-order, B2 launches = the first camera's ticks, and a 'w'
    restarting only the first camera's backend without a scene sync."""
    from bifrost3d_tpu_torch.apps.interactive_viewer import CameraNavigation
    from bifrost3d_tpu_torch.core import Keyboard
    rig = _EngineRig(device, "Box", RES)
    d = rig.data
    cam2 = d.cameras.create("pip", d.cameras._get(rig.cam).scene_root,
                            transform=d.cameras.get_transform(rig.cam),
                            z_index=1)
    d.cameras.set_renderer(cam2, rig.ids["Preview"])
    torch.cuda.synchronize()
    _reset_counts()
    ticks = [rig.tick() for _ in range(ENGINE_TICKS)]
    counts = _trace_counts()
    scene = rig.scene()
    lights = scene.lights.count
    want = dict(B1=ENGINE_TICKS * (1 + lights), B2_B3=ENGINE_TICKS, B4=0,
                B6=0, B7=0)
    check(counts == want, f"E3: launches {counts}, expected {want}")
    _expect_megakernel(scene, rig.settings, "E3 Box")
    frames = rig.comp.render()
    check(list(frames) == [int(rig.cam), int(cam2)], f"E3: frames in order "
          f"{list(frames)}")
    kb = Keyboard()
    kb.press("w")
    kb.release("w")
    CameraNavigation(d, rig.cam).handle(kb, 1.0 / 30)
    moved = rig.tick()
    first, second = rig.backend().accumulations, rig.backend(cam2).accumulations
    check(rig.scene() is scene, "E3: a camera move synced the scene")
    check(first == 1 and second == ENGINE_TICKS + 2,
          f"E3: accumulations after 'w' {first}, {second}")
    med = _median_ticks(ticks)
    print(f"engine/E3 Box {int(scene.tri_verts.shape[0])} triangles, "
          f"{RES}x{RES}, camera 1 PathTracer, camera 2 (z-index 1) Preview: "
          f"frames in z-order, launches over {ENGINE_TICKS} ticks {counts} | "
          f"tick {med['ms']:.3f} ms (median of the last 4: sync "
          f"{med['sync']:.3f}, render {med['render']:.3f} both cameras, post "
          f"{med['post']:.3f}) | 'w': the same RenderScene, camera 1 "
          f"restarted at {first}, camera 2 at {second}, tick "
          f"{moved['ms']:.2f} ms | {card}", flush=True)
    return dict(launches=counts["B2_B3"], median=med, counts=counts)


def _engine_e4(device, card) -> dict:
    """E4: the renderer toggle and the settings panel on Sphere: Preview
    (B1 layers × (1 + lights) a frame), Denoised (B3 a frame, its AOV
    trace B1 once), max bounces +1, path regularization 0.5 (the pooled
    wavefront on B1)."""
    from bifrost3d_tpu_torch.apps.interactive_viewer import RenderingPanel
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    rig = _EngineRig(device, "Sphere", RES)
    panel = RenderingPanel(rig.data, rig.comp, rig.cam,
                           list(rig.ids.items()))
    rig.tick()
    rig.tick()
    lights = rig.scene().lights.count
    out = {}

    def mode(name, keys, want):
        for k in keys:
            check(panel.handle(k), f"E4 {name}: the panel refused {k!r}")
        torch.cuda.synchronize()
        _reset_counts()
        ticks = [rig.tick() for _ in range(ENGINE_EDIT_TICKS)]
        counts = _trace_counts()
        for k, v in counts.items():
            w = want.get(k, 0)
            check(v > 0 if w == "> 0" else v == w,
                  f"E4 {name}: launches {counts}, expected {want}")
        b = rig.backend()
        out[name] = dict(counts=counts, ms=[t["ms"] for t in ticks],
                         accumulations=b.accumulations,
                         path=pt.explain_render_path(
                             rig.scene(), getattr(b, "settings",
                                                  rig.settings)))

    n = ENGINE_EDIT_TICKS
    mode("Preview", ["g", "right"], dict(B1=n * (1 + lights)))
    mode("Denoised", ["right"], dict(B2_B3=n, B1=1))
    mode("PathTracer", ["right"], dict(B2_B3=n))
    mode("max bounces +1", ["down", "right"], dict(B2_B3=n))
    bounces = rig.backend().settings.max_bounce_count
    check(bounces == ENGINE_BOUNCES + 1 and
          out["max bounces +1"]["accumulations"] == n,
          f"E4: bounces {bounces}, accumulations "
          f"{out['max bounces +1']['accumulations']}")
    mode("path reg. 0.5", ["down", "down", "right"], {"B1": "> 0"})
    check(rig.backend().settings.path_regularization_scale == 0.5 and
          "path regularization" in out["path reg. 0.5"]["path"],
          f"E4: {out['path reg. 0.5']['path']}")
    for name, r in out.items():
        print(f"engine/E4 {name}: {RES}x{RES}, launches over {n} ticks "
              f"{r['counts']}, ticks " + ", ".join(f"{ms:.2f}" for ms in
                                                  r["ms"])
              + f" ms, {r['accumulations']} accumulations, {r['path']} | "
              f"{card}", flush=True)
    return dict(launches=sum(r["counts"]["B1"] for r in out.values()),
                modes=out)


def _engine_e5(card) -> dict:
    """E5: the app itself in a process of its own, at its default window
    and at 512²: exit 0, nothing printed (no terminal: JAX's app prints
    nothing either), the screenshot written, finite and lit."""
    from bifrost3d_tpu_torch.io.image import load_image
    out = {}
    for size in (None, f"{RES}x{RES}"):
        shot = os.path.join(ENGINE_DIR, f"shot_{size or 'default'}.png")
        if os.path.exists(shot):
            os.remove(shot)
        argv = [sys.executable, "-m", "bifrost3d_tpu_torch.apps."
                "interactive_viewer", "--scene", "Sphere", "--ticks", "12",
                "--keys", "wwdpxp", "--screenshot", shot]
        if size:
            argv += ["--window-size", size]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=300, cwd=REPO)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"E5 {size}: exit {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        check(proc.stdout == "", f"E5 {size}: printed {proc.stdout[-500:]!r}")
        img = load_image(shot)
        check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.02,
              f"E5 {size}: screenshot mean {float(img.mean())}")
        out[size or "96x54"] = dict(seconds=seconds, shape=img.shape,
                                    mean=float(img.mean()))
    for size, r in out.items():
        print(f"engine/E5 python -m bifrost3d_tpu_torch.apps."
              f"interactive_viewer --scene Sphere --ticks 12 --keys wwdpxp "
              f"({size}): exit 0 in {r['seconds']:.2f} s, nothing printed, "
              f"screenshot {r['shape'][1]}x{r['shape'][0]} mean "
              f"{r['mean']:.3f} | {card}", flush=True)
    return out


def engine_phase(device, card) -> dict:
    """Phase 24: the engine and the live viewer on the card: E1 the
    compositor's path tracer on Sphere (B3), E2 SceneSync's incremental
    edits, E3 two cameras on Box (B2 and the preview's B1), E4 the
    renderer toggle and the settings panel, E5 the app itself."""
    os.makedirs(ENGINE_DIR, exist_ok=True)
    t0 = time.perf_counter()
    e1 = _engine_e1(device, card)
    out = dict(E1=e1, E2=_engine_e2(device, card, e1.pop("rig")),
               E3=_engine_e3(device, card), E4=_engine_e4(device, card),
               E5=_engine_e5(card))
    print(f"engine: E1–E5 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- phase 25: parallel/ (sharded renders and train steps) --------------------

PARALLEL_SHARDS = 4
PARALLEL_ODD_HEIGHT = 509     # not a multiple of the shard count
PARALLEL_SMALLPT = (1024, 768)
PARALLEL_TRAIN_STEPS = 3
# At tests/test_parallel.py's 2e-2 the first Adam steps, which move every
# parameter by about the rate whatever its gradient's size, raise this
# scene's loss (my CPU runs at 24², 64² and 128², 2 bounces); at 5e-3 the
# first update lowers it at each.
PARALLEL_TRAIN_LR = 5e-3
ALLREDUCE_ATOL, ALLREDUCE_RTOL = 2e-6, 2e-4   # tests/test_parallel.py
SHARD_GATE = 1e-5             # sharded vs unsharded frame, max |d|


def _peak_run(fn):
    """fn() with the peak memory reset before → (result, ms to a
    synchronise, peak bytes above what was held before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() - held


def _sharded_case(what, sharded, unsharded, card) -> dict:
    """A sharded frame with every count at 0 before, against the unsharded
    frame of the same inputs (max |d| <= SHARD_GATE); an unsharded frame
    first, untimed, so that neither time holds a build or a cache fill."""
    unsharded()
    _reset_counts()
    img, ms, peak = _peak_run(sharded)
    counts = _trace_counts()
    ref, ref_ms, _ = _peak_run(unsharded)
    check(img.shape == ref.shape, f"parallel/{what}: shape {tuple(img.shape)}"
          f" vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-4,
          f"parallel/{what}: frame not finite or black")
    err = float((img - ref).abs().max())
    check(err <= SHARD_GATE, f"parallel/{what}: max |d| {err:.3e} against "
          f"the unsharded frame")
    print(f"parallel/{what}: {ms:.1f} ms sharded, {ref_ms:.1f} ms unsharded "
          f"| peak {_gib(peak)} above the scene | max |d| vs unsharded "
          f"{err:.3e} (bit-equal: {bool(torch.equal(img, ref))}) | launches "
          f"{counts} | {card}", flush=True)
    return dict(ms=ms, unsharded_ms=ref_ms, peak=peak, max_abs_err=err,
                counts=counts, bit_equal=bool(torch.equal(img, ref)))


def _parallel_p4(device, card) -> dict:
    """P4: make_sharded_train_step on bench_backward's scene over 2 shards,
    3 steps; the first step's loss and gradients against one shard's."""
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.parallel import make_sharded_train_step
    scene, cam = create_cornell_box(device=device)
    settings = pt.settings_for_scene(scene, max_bounce_count=TRAIN_BOUNCES)
    with torch.no_grad():
        target = pt.render_sample(scene, cam, TRAIN_RES, TRAIN_RES, 0,
                                  settings)
    start = scene._replace(materials=scene.materials._replace(
        tint=torch.clamp(scene.materials.tint * 0.6 + 0.15, 0.0, 1.0)))
    runs = {}
    # An untimed first step fills the scene's caches.
    warm_init, warm_step = make_sharded_train_step(
        [device], TRAIN_RES, TRAIN_RES, settings,
        learning_rate=PARALLEL_TRAIN_LR)
    warm_step(*warm_init(start), start, cam, target, 0)
    for shards in (1, 2):
        init_fn, step_fn = make_sharded_train_step(
            [device] * shards, TRAIN_RES, TRAIN_RES, settings,
            learning_rate=PARALLEL_TRAIN_LR)
        params, state = init_fn(start)
        steps = []
        for _ in range(PARALLEL_TRAIN_STEPS if shards == 2 else 1):
            _reset_counts()
            (params, state, loss), ms, peak = _peak_run(
                lambda: step_fn(params, state, start, cam, target, 0))
            steps.append(dict(loss=float(loss), ms=ms, peak=peak,
                              B1=_trace_counts()["B1"],
                              grads={k: v / 0.1 for k, v in state.mu.items()}
                              if state.count == 1 else None))
        runs[shards] = steps
    one, two = runs[1][0], runs[2][0]
    worst = 0.0
    check(abs(two["loss"] - one["loss"]) <= ALLREDUCE_ATOL
          + ALLREDUCE_RTOL * abs(one["loss"]), f"parallel/P4: loss "
          f"{two['loss']} vs one shard's {one['loss']}")
    for name, g in two["grads"].items():
        ref = one["grads"][name]
        check(bool(torch.isfinite(g).all()) and bool(torch.allclose(
            g, ref, rtol=ALLREDUCE_RTOL, atol=ALLREDUCE_ATOL)),
              f"parallel/P4: gradient of {name} differs from one shard's")
        worst = max(worst, float((g - ref).abs().max()))
    losses = [s["loss"] for s in runs[2]]
    check(losses[1] < losses[0], f"parallel/P4: the first update did not "
          f"lower the loss: {losses}")
    out = dict(losses=losses, ms=[s["ms"] for s in runs[2]],
               unsharded_ms=one["ms"], peak=max(s["peak"] for s in runs[2]),
               launches=sum(s["B1"] for s in runs[2]), grad_max_abs=worst)
    print(f"parallel/P4: make_sharded_train_step, CornellBox {TRAIN_RES}² "
          f"{TRAIN_BOUNCES} bounces, 2 shards, {PARALLEL_TRAIN_STEPS} steps "
          f"(lr {PARALLEL_TRAIN_LR}) | losses {', '.join(f'{x:.6f}' for x in losses)}"
          f" | step ms {', '.join(f'{x:.1f}' for x in out['ms'])} (one shard "
          f"{one['ms']:.1f}) | peak {_gib(out['peak'])} above the scene | "
          f"first step vs one shard: loss within {abs(two['loss'] - one['loss']):.3e},"
          f" gradients max |d| {worst:.3e} (atol {ALLREDUCE_ATOL}, rtol "
          f"{ALLREDUCE_RTOL}) | B1 launches {out['launches']} | {card}",
          flush=True)
    return out


def _parallel_p5(card) -> dict:
    """P5: run_selftest with 2 gloo ranks on the card, then world size 1
    (nccl), each process against the single-process frames."""
    from bifrost3d_tpu_torch.parallel.distributed import run_selftest
    out = {}
    for name, processes in (("gloo", 2), ("nccl", 1)):
        t0 = time.perf_counter()
        report = run_selftest(num_processes=processes, devices_per_process=2,
                              timeout=300.0, device="cuda")
        seconds = time.perf_counter() - t0
        check(f"backend={name}" in report and "device=cuda" in report,
              f"parallel/P5: {report}")
        out[name] = dict(seconds=seconds, report=report)
        print(f"parallel/P5: run_selftest({processes} process(es) x 2 shards "
              f"on the card): {report} in {seconds:.1f} s | {card}",
              flush=True)
    return out


def parallel_phase(device, card) -> dict:
    """Phase 25: parallel/ on the card. P1 the sharded CornellBox render
    (B1), P2 the sharded torus grid (B4), P3 the sharded SmallPT frame, P4
    the sharded train step, P5 the multi-process self-test."""
    from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES, create_cornell_box
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.integrator.smallpt import (
        render_smallpt_accumulation)
    from bifrost3d_tpu_torch.parallel import (
        make_sharded_render, make_sharded_smallpt)
    from bifrost3d_tpu_torch.scene.spheres import smallpt_scene
    t_phase = time.perf_counter()
    out = {}
    scene, cam = create_cornell_box(device=device)
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    mesh = [device] * PARALLEL_SHARDS
    for height in (RES, PARALLEL_ODD_HEIGHT):
        def unsharded():
            return pt.render_pixels_pooled(scene, cam, RES, height, 1,
                                           settings)[0].reshape(height, RES, 3)
        case = _sharded_case(
            f"P1 CornellBox {RES}x{height} {BOUNCES} bounces over "
            f"{PARALLEL_SHARDS} shards",
            lambda: make_sharded_render(mesh, RES, height, settings)(
                scene, cam, 1), unsharded, card)
        check(case["counts"]["B1"] > 0 and case["counts"]["B4"] == 0,
              f"parallel/P1: launches {case['counts']}")
        out[f"P1/{height}"] = case
    del scene, cam

    t_scene, t_cam = TEST_SCENES["torus_grid"](device=device)
    t_settings = pt.settings_for_scene(t_scene, max_bounce_count=BOUNCES)
    case = _sharded_case(
        f"P2 torus_grid ({int(t_scene.tri_verts.shape[0])} triangles) "
        f"{TORUS_RES}² {BOUNCES} bounces over 2 shards",
        lambda: make_sharded_render([device] * 2, TORUS_RES, TORUS_RES,
                                    t_settings)(t_scene, t_cam, 1),
        lambda: pt.render_pixels_pooled(t_scene, t_cam, TORUS_RES, TORUS_RES,
                                        1, t_settings)[0].reshape(
            TORUS_RES, TORUS_RES, 3), card)
    check(case["counts"]["B4"] > 0 and case["counts"]["B1"] == 0,
          f"parallel/P2: launches {case['counts']}")
    out["P2"] = case
    del t_scene, t_cam

    s_scene = smallpt_scene(device=device)
    w, h = PARALLEL_SMALLPT
    out["P3"] = _sharded_case(
        f"P3 SmallPT {w}x{h} (plain) over {PARALLEL_SHARDS} shards",
        lambda: make_sharded_smallpt(mesh, w, h)(s_scene, 1),
        lambda: render_smallpt_accumulation(s_scene, w, h, 1), card)
    out["P4"] = _parallel_p4(device, card)
    out["P5"] = _parallel_p5(card)
    out["launches_B1"] = (sum(out[f"P1/{h}"]["counts"]["B1"]
                              for h in (RES, PARALLEL_ODD_HEIGHT))
                          + out["P4"]["launches"])
    out["launches_B4"] = out["P2"]["counts"]["B4"]
    print(f"parallel: P1–P5 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# -- phase 26: the fits (precompute_fittings, the GGX LTC table, dev_analysis)

FITS_SAMPLES = 4096
DIELECTRIC_MAX, DIELECTRIC_MEAN = 1e-2, 1e-4
LTC_ROW_SUM_MARGIN = 2.0      # a row's summed objective vs the shipped
LTC_QUALITY = ((0.9, 0.4), (0.5, 0.6), (0.7, 0.9))  # tests/test_ltc.py
LTC_QUALITY_L1 = 0.12


def _ltc_objective(table, device) -> np.ndarray:
    """The fit's own objective of every cell of a [R, C, 4] table, in
    float64 on ``device`` → [R, C]."""
    from bifrost3d_tpu_torch.shading import ltc_fit
    r, c = table.shape[:2]
    cos = torch.clamp_min(torch.arange(c, dtype=torch.float64, device=device)
                          / (c - 1), ltc_fit._MIN_FIT_COS)
    u2 = ltc_fit._stratified_u2(16, device, torch.float64)
    out = np.zeros((r, c))
    t = table.astype(np.float64)
    p = np.concatenate([np.log(t[..., :2]), t[..., 2:]], axis=-1)
    for j in range(r):
        objective = ltc_fit._make_row_objective(
            cos, ltc_fit._row_alpha(j, r), u2)
        out[j] = objective(torch.tensor(p[j], device=device)[:, None, :])[
            :, 0].cpu().numpy()
    return out


def _ltc_quality(table, device) -> list:
    """tests/test_ltc.py's fit gate on ``table``: the relative L1 between
    the LTC and the normalized GGX D·G lobe over 8,192 GGX samples at each
    (cos θ, roughness) of LTC_QUALITY."""
    from bifrost3d_tpu_torch.bsdf import ggx
    from bifrost3d_tpu_torch.math import ltc
    from bifrost3d_tpu_torch.shading.ltc_fit import (
        ggx_reflection_ltc_coefficients)
    table = torch.tensor(table, device=device)
    u = torch.tensor(np.random.default_rng(6).uniform(size=(8192, 2)),
                     dtype=torch.float32, device=device)
    out = []
    for cos_t, rough in LTC_QUALITY:
        alpha = ggx.alpha_from_roughness(torch.tensor(rough, device=device))
        lt = ggx_reflection_ltc_coefficients(
            torch.tensor(cos_t, device=device),
            torch.tensor(rough, device=device), table)
        wo = torch.tensor([math.sqrt(1 - cos_t ** 2), 0.0, cos_t],
                          device=device).expand(8192, 3)
        s = ggx.r_sample(alpha.expand(8192), 1.0, wo, u)
        f = ggx.r_evaluate(alpha, 1.0, wo, s.direction)[..., 0]
        cos_wi = torch.clamp_min(s.direction[..., 2], 0.0)
        weight = torch.where(s.pdf > 1e-12,
                             f * cos_wi / torch.clamp_min(s.pdf, 1e-12), 0.0)
        d_ggx = f * cos_wi / weight.mean()
        ok = s.pdf > 1e-9
        d_ltc = ltc.pdf(lt, s.direction)
        out.append(float((d_ltc[ok] - d_ggx[ok]).abs().mean()
                         / d_ggx[ok].mean()))
    return out


def _fits_l1(device, card) -> dict:
    from bifrost3d_tpu_torch.shading import fittings
    (card_tables), ms, peak = _peak_run(lambda: fittings.precompute_fittings(
        FITS_SAMPLES, os.path.join(REPO, "build", "shading", "fittings.npz"),
        device=device))
    t0 = time.perf_counter()
    cpu_tables = fittings.precompute_fittings(FITS_SAMPLES, None, device="cpu")
    cpu_s = time.perf_counter() - t0
    out = dict(ms=ms, peak=peak, cpu_s=cpu_s, tables={})
    with np.load(fittings.FITTINGS_PATH) as shipped:
        for name in fittings.Fittings._fields:
            got = getattr(card_tables, name).cpu().numpy()
            vs_cpu = float(np.abs(got - getattr(cpu_tables, name).numpy()
                                  ).max())
            vs_shipped = float(np.abs(got - shipped[name]).max())
            # test_torch_fittings_precompute.py's gates: a dielectric cell
            # averages sample weights whose float32 value moves by up to 1%
            # on near-grazing, near-smooth lanes, and that does not average
            # out over more samples.
            diff = np.abs(got - getattr(cpu_tables, name).numpy())
            gate = (DIELECTRIC_MAX, DIELECTRIC_MEAN) if name.startswith(
                "dielectric") else (1e-5, 1e-5)
            check(np.isfinite(got).all() and diff.max() <= gate[0]
                  and diff.mean() <= gate[1], f"fits/L1 {name}: card vs CPU "
                  f"max |d| {diff.max():.3e}, mean {diff.mean():.3e}, gate "
                  f"{gate}")
            out["tables"][name] = dict(vs_cpu=vs_cpu, vs_shipped=vs_shipped)
    print(f"fits/L1: precompute_fittings({FITS_SAMPLES}) on the card in "
          f"{ms:.1f} ms (the CPU's {cpu_s:.1f} s), peak {_gib(peak)} | max "
          f"|d| card vs CPU / vs the shipped fittings.npz: "
          + "; ".join(f"{k} {v['vs_cpu']:.2e} / {v['vs_shipped']:.2e}"
                      for k, v in out["tables"].items()) + f" | {card}",
          flush=True)
    return out


def _fits_l2(device, card) -> dict:
    from bifrost3d_tpu_torch.shading import ltc_fit
    # The captured iteration (a CUDA graph) against the eager loop: the
    # roughest row from zeros, bit for bit.
    cos = torch.clamp_min(torch.arange(64, device=device) / 63.0,
                          ltc_fit._MIN_FIT_COS)
    u2 = ltc_fit._stratified_u2(16, device)
    row_fit, rows_ms = {}, {}
    for graph in (True, False):
        row_fit[graph], row_ms, _ = _peak_run(lambda: ltc_fit.fit_row(
            cos, ltc_fit._row_alpha(63, 64), torch.zeros((64, 4),
                                                         device=device), u2,
            ltc_fit._NM_ITERATIONS, graph=graph))
        rows_ms[graph] = row_ms
    check(all(torch.equal(a, b) for a, b in zip(row_fit[True],
                                                 row_fit[False])),
          "fits/L2: the captured Nelder-Mead row differs from the eager one")
    table, ms, peak = _peak_run(lambda: ltc_fit.precompute_ggx_ltc(
        os.path.join(REPO, "build", "shading", "ggx_ltc.npz"),
        device=device))
    with np.load(ltc_fit.TABLE_PATH) as data:
        shipped = data["ggx_ltc"]
    check(table.shape == shipped.shape and np.isfinite(table).all()
          and (table[..., :2] > 0).all(), "fits/L2: table not finite")
    got, ref = _ltc_objective(table, device), _ltc_objective(shipped, device)
    rows = got.sum(axis=1) / ref.sum(axis=1)
    excess = float(((got - ref) / ref.sum(axis=1, keepdims=True)).max())
    ratio = got / ref
    quality = _ltc_quality(table, device)
    check(rows.max() <= LTC_ROW_SUM_MARGIN, f"fits/L2: a row's objective "
          f"{rows.max():.3f} x the shipped table's")
    check(excess <= 1.0, f"fits/L2: a cell's objective exceeds the shipped "
          f"table's by {excess:.3f} x its row's total")
    check(max(quality) < LTC_QUALITY_L1, f"fits/L2: relative L1 {quality}")
    out = dict(ms=ms, peak=peak, row_ms=(rows_ms[True], rows_ms[False]),
               row_ratio=(float(rows.min()), float(rows.max())),
               excess=excess, cell_ratio=np.quantile(
                   ratio, [0.0, 0.01, 0.5, 0.99, 1.0]).tolist(),
               cells_over_2=int((ratio > 2).sum()), quality=quality)
    print(f"fits/L2: precompute_ggx_ltc 64 x 64 cells, {ltc_fit._NM_ITERATIONS}"
          f" Nelder-Mead iterations a row, on the card in {ms / 1e3:.1f} s, "
          f"peak {_gib(peak)} (one row: {rows_ms[True]:.1f} ms as a "
          f"captured iteration replayed, {rows_ms[False]:.1f} ms eager, bit "
          f"for bit) | the fit's objective against the shipped "
          f"table's: rows {rows.min():.3f}–{rows.max():.3f} x (gate "
          f"{LTC_ROW_SUM_MARGIN}), cells quantiles 0/1/50/99/100% "
          + "/".join(f"{x:.3g}" for x in out["cell_ratio"])
          + f" x, {out['cells_over_2']} of {ratio.size} cells above 2 x, "
          f"largest excess {excess:.3f} of its row's total (gate 1.0) | "
          f"relative L1 to GGX at {LTC_QUALITY}: "
          + ", ".join(f"{q:.4f}" for q in quality)
          + f" (gate {LTC_QUALITY_L1}) | {card}", flush=True)
    return out


def _fits_l3(device, card) -> dict:
    from bifrost3d_tpu_torch.apps import dev_analysis
    out, ms, peak = _peak_run(lambda: dev_analysis.main(
        ["all", "--device", str(device)]))
    check(sorted(out) == ["normals", "seeding", "sss"], f"fits/L3: {out}")
    for name, row in out["sss"].items():
        check(abs(row["profile_integral"] - 1.0) < 1e-3,
              f"fits/L3: the SSS profile integral {row}")
    check(all(np.isfinite(v["mean_deg"]) for v in out["normals"].values()),
          "fits/L3: normals")
    print(f"fits/L3: dev_analysis all on the card in {ms:.1f} ms, peak "
          f"{_gib(peak)} | seeding error std "
          + ", ".join(f"{k} {v['error_std']:.4f}"
                      for k, v in out["seeding"].items())
          + " | normals mean° " + ", ".join(
              f"{k} {v['mean_deg']:.5f}" for k, v in out["normals"].items())
          + " | sss mean r " + ", ".join(
              f"{k} {v['mean_r']:.4f}" for k, v in out["sss"].items())
          + f" | {card}", flush=True)
    return dict(ms=ms, peak=peak)


def fits_phase(device, card) -> dict:
    """Phase 26: the offline fits on the card. L1 precompute_fittings, L2
    the 64 x 64 GGX LTC fit, L3 dev_analysis all."""
    t0 = time.perf_counter()
    out = dict(L1=_fits_l1(device, card), L2=_fits_l2(device, card),
               L3=_fits_l3(device, card))
    print(f"fits: L1–L3 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


PARITY_DIR = os.path.join(REPO, "build", "parity")


def _torch_parity():
    """tests/torch_parity (the shader-ball writer and the float64 gate),
    with this process's torch thread count kept: its import sets one
    thread, for pytest's workers."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    threads = torch.get_num_threads()
    import torch_parity
    torch.set_num_threads(threads)
    return torch_parity


def _parity_ball(device, card) -> dict:
    """P1: the shader-ball MaterialScene on B3's kExtras instantiation."""
    from bifrost3d_tpu_torch.apps import scenes
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    os.makedirs(PARITY_DIR, exist_ok=True)
    path = os.path.join(PARITY_DIR, "Shaderball.gltf")
    ball_tris = _torch_parity().write_shader_ball(path, slices=48,
                                                  stacks=24)
    with mock.patch.object(scenes, "SHADERBALL_PATH", path):
        t0 = time.perf_counter()
        scene, cam = scenes.create_material_scene(device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    n_tris = int(scene.tri_verts.shape[0])
    floor = int((scene.tri_material == 0).sum())
    check(n_tris == floor + scenes.MATERIAL_SCENE_COUNT * ball_tris,
          f"P1: {n_tris} triangles, not the floor's {floor} and seven balls "
          f"of {ball_tris}")
    settings = pt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    small, args, _ = _gate_tiled_scene("shaderball", scene, cam, SMALL_RES,
                                       settings, device)
    small.pop("pooled")
    check(args[-1].hier and args[-1].extras,
          "P1: not the BVH branch's kExtras instantiation")
    out = _extras_path("shaderball", scene, cam, tag="parity/P1")
    out.update(small=small, build_s=build_s, ball_tris=ball_tris)
    print(f"parity/P1 shaderball: {out['path']}, kExtras | {n_tris} tris "
          f"({ball_tris} a ball, floor {floor}), scene in {build_s:.2f} s | "
          f"{SMALL_RES}x{SMALL_RES}: B3 vs plain {small['flips']:.5f} flips,"
          f" means {small['mean_rel']:.2e} apart, vs wavefront "
          f"{small['wavefront_flips']:.4f} flips | {RES}x{RES} x"
          f"{ACCUMULATIONS}: {out['launches']} B3 launches | {card}",
          flush=True)
    return out


def _parity_smallpt(device, card) -> dict:
    """P2: B5 through the SmallPT app against the float64 reference."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import smallpt_reference
    from bifrost3d_tpu_torch.apps import smallpt_app
    from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt

    w, h, n = 64, 48, 32        # tests/test_smallpt.py:20
    smallpt_app.render_progressive(w, h, 1, quiet=True, device=device)
    _reset_counts()
    img = smallpt_app.render_progressive(w, h, n, quiet=True, device=device)
    check(spt.launch_count == n, f"P2: {spt.launch_count} B5 launches for "
          f"{n} frames")
    t0 = time.perf_counter()
    ref = smallpt_reference.render(w, h, n)
    ref_s = time.perf_counter() - t0
    # tests/test_smallpt.py:63-80; an AssertionError ends the script.
    gate = _torch_parity().assert_float64_reference_gate(img.cpu().numpy(),
                                                         ref)
    rel_rms, within = gate["rel_rms"], gate["within_2pct"]
    mean_rel = abs(gate["mean"] - gate["ref_mean"]) / gate["ref_mean"]
    print(f"parity/P2 smallpt_app {w}x{h} x{n} on B5 ({spt.launch_count} "
          f"launches) vs the float64 reference "
          f"({ref_s:.1f} s on the host): relative RMS {rel_rms:.4f} (< 0.20),"
          f" {within:.4f} of the pixels within 2% (> 0.80), means "
          f"{mean_rel:.2e} apart (< 0.03) | {card}", flush=True)
    return dict(launches=n, rel_rms=rel_rms, within=within,
                mean_rel=mean_rel)


def _parity_viewer(device, card) -> dict:
    """P3: the headless interactive viewer prints nothing."""
    import contextlib
    import io
    from bifrost3d_tpu_torch.apps import interactive_viewer as iv
    shot = os.path.join(PARITY_DIR, "viewer_shot.png")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        frames, data, comp = iv.run(
            scene_name="Box", width=32, height=24, ticks=4,
            scripted_keys="wx", display=False, screenshot_path=shot,
            device=device)
    said = said.getvalue()
    check(said == "", f"P3: the headless run printed {said[-500:]!r}")
    check(os.path.getsize(shot) > 0, "P3: no screenshot")
    (cam, frame), = frames.items()
    renderer = comp.renderers.get_name(data.cameras.get_renderer(cam))
    check(tuple(frame.shape[:2]) == (24, 32)
          and bool(torch.isfinite(frame).all()),
          f"P3: frame {tuple(frame.shape)}")
    print(f"parity/P3 interactive_viewer.run Box 32x24, 4 ticks, no "
          f"terminal: printed nothing; {renderer} frame "
          f"{frame.shape[1]}x{frame.shape[0]}, screenshot written | {card}",
          flush=True)
    return dict(renderer=renderer)


def parity_phase(device, card) -> dict:
    """Phase 27: the shader-ball MaterialScene (P1), B5 against the
    float64 SmallPT reference (P2), the silent headless viewer (P3)."""
    t0 = time.perf_counter()
    out = dict(P1=_parity_ball(device, card),
               P2=_parity_smallpt(device, card),
               P3=_parity_viewer(device, card))
    print(f"parity: P1–P3 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def post_phase(device) -> dict:
    """Phase 28: the post chain's two kernels (``post/post_chain.py``) at
    512² with the viewer's settings (histogram exposure, eye adaptation
    snapping, vignette 0.63, filmic, no grain) against the eager chain on
    the card (LDR max abs and exposure relative ≤ 1e-5), with no host sync
    (sync debug mode raising); launches a call."""
    from bifrost3d_tpu_torch.post import pipeline, post_chain
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
    rng = np.random.default_rng(28)
    image = torch.tensor(np.exp(rng.normal(-1.0, 1.5, (RES, RES, 3)))
                         .astype(np.float32), device=device)
    settings = CameraEffectsSettings.preset()._replace(film_grain=0.0)

    def fused():
        return pipeline._process(image, settings, 0, -1.0, 0.0)

    ldr, exposure = fused()
    ref, ref_exposure = pipeline._process_plain(image, settings, 0, -1.0, 0.0)
    err = float((ldr - ref).abs().max())
    rel = abs(float(exposure) / float(ref_exposure) - 1.0)
    check(err <= 1e-5 and rel <= 1e-5,
          f"post: kernels vs eager chain LDR {err:.3g}, exposure {rel:.3g}")
    before = post_chain.launch_count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = post_chain.launch_count - before
    print(f"post: {RES}² kernels {launches} launches a call, no host sync; "
          f"against the eager chain LDR {err:.3g}, exposure {rel:.3g}",
          flush=True)
    return dict(launches=launches, max_abs_err=err, exposure_rel=rel)


def _kernel_row(name, source, replaces, launches, result) -> dict:
    """One kernel's entry of the JSON line; a culled trace (B1, B6) also
    gives the bound of the full scan or the TPU design it replaces, beside
    the bound of its own work."""
    row = {"name": name, "route": "cuda",
           "source": f"bifrost3d_tpu_torch/csrc/{source}",
           "replaces": replaces, "launches": launches,
           "max_abs_err": result["max_abs_err"], "ms": result["ms"],
           "plain_ms": result["plain_ms"], "bound_ms": result["bound_ms"],
           "bound_by": result["bound_by"], "library_ms": None}
    if "bound_full_ms" in result:
        row["bound_full_ms"] = result["bound_full_ms"]
    return row


def main() -> int:
    start = last = time.perf_counter()

    def lap(phases):
        nonlocal last
        now = time.perf_counter()
        print(f"time: {phases} done {now - start:.1f} s after the start, "
              f"{now - last:.1f} s", flush=True)
        last = now
    card = device_phase()
    device = torch.device("cuda", 0)
    build_phase()
    lap("build")
    rng_phase(device)
    camera_phase(device)
    trace_probe_phase(device)
    soups = _soups(device)
    lap("rng, camera and trace probe")
    device_times = fresh_process("traces")
    lap("traces (a process of its own)")
    kernels = kernel_phase(device, soups, device_times)
    sliced = slice_phase(device)
    lap("kernel/dense and slice")
    megakernel_phase(device)
    progressive_phase(device)
    lap("megakernel and progressive")
    smallpt_kernel_phase(device)
    bvh = bvh_kernel_phase(device, soups["sphere"])
    lap("kernel/smallpt and kernel/bvh")
    smallpt_path_phase(device)
    path_b = torus_path_phase(device)
    lap("smallpt and torus_grid paths")
    clusters = cluster_kernel_phase(device, soups["sphere"], device_times)
    lap("kernel/clustered and kernel/vmem")
    hier_scenes = megakernel_hier_phase(device)
    hier_walk_phase(device)
    path_c = hier_path_phase(device)
    lap("megakernel/hier, walk and hier_bridge")
    packings = packing_path_phase(device,
                                  hier_scenes["hier_bridge_15k"]["pooled"])
    lap("packings")
    for packing in ("dense", "clustered", "vmem"):
        fresh_process(f"pooled-{packing}")
    lap("pooled frames (three processes)")
    megakernel_extras_phase(device)
    lap("megakernel/extras")
    path_d = extras_path_phase(device)
    viewer_phase(device)
    frame_profile_phase(device)
    lap("extras paths, viewer and profile")
    viewer_scenes_phase(device, card, path_d)
    lap("viewer_scenes")
    files = files_phase(device, card)
    lap("files")
    modes = viewer_modes_phase(device, card)
    lap("viewer_modes")
    engine = engine_phase(device, card)
    lap("engine")
    train = train_phase(device, card)
    lap("train")
    train_profile(fresh_process("train"), card)
    lap("train profile (a process of its own)")
    parallel = parallel_phase(device, card)
    lap("parallel")
    fits_phase(device, card)
    lap("fits")
    parity_phase(device, card)
    lap("parity")
    post_phase(device)
    lap("post")
    # The four trace kernels, and the megakernel's two instantiations that
    # no cell runs: B3's kHier without kExtras (the bridge) and B2's dense
    # trace with kExtras (Sphere, Opacity). The cells time B2 without
    # kExtras, B3 with it, B5 and the post chain. No single PyTorch call
    # computes any of them: library_ms is null.
    print(json.dumps({"kernels": [
        _kernel_row("dense_intersect", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    sliced["launches"], kernels["cornell/incoherent"]),
        _kernel_row("bvh_intersect", "bvh_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh.py:240",
                    path_b["launches"], bvh["incoherent"]),
        _kernel_row("mesh_megakernel_hier", "mesh_megakernel.cu",
                    "bifrost3d_tpu/integrator/pallas_mesh.py:898",
                    path_c, hier_scenes[BRIDGE_SCENE]),
        _kernel_row("clustered_intersect", "clustered_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_clustered.py:96",
                    packings["clustered"]["launches"],
                    clusters["bridge/incoherent"]["clustered"]),
        _kernel_row("vmem_intersect", "vmem_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh_vmem.py:139",
                    packings["vmem"]["launches"],
                    clusters["bridge/incoherent"]["vmem"]),
        # B2's kExtras instantiation on main path D.
        *(_kernel_row(f"mesh_megakernel/{name}", "mesh_megakernel.cu",
                      "bifrost3d_tpu/integrator/pallas_mesh.py:1541",
                      path_d[name]["launches"], path_d[name])
          for name in ("Sphere", "Opacity")),
        # The two traces again on main path E, the gradient path: the three
        # plain Cornell train steps (B1) and the torus grid's step (B4),
        # each timed at the same ray count in its kernel phase.
        _kernel_row("dense_intersect/train", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    train["plain"]["launches"], kernels["cornell/incoherent"]),
        _kernel_row("bvh_intersect/train", "bvh_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh.py:240",
                    train["torus"]["launches"], bvh["incoherent"]),
        # The kernels again on the files phase: F1 (an OBJ, B3), F2 (a
        # textured GLB, B4), F3 (an EXR map, B1 on CornellBox and the OBJ),
        # F4 (the AOV trace, B1 on the OBJ and B4 on the GLB), each with the
        # timing row of its kernel phase.
        _kernel_row("mesh_megakernel_hier/obj", "mesh_megakernel.cu",
                    "bifrost3d_tpu/integrator/pallas_mesh.py:898",
                    files["F1"]["launches"], hier_scenes[BRIDGE_SCENE]),
        _kernel_row("bvh_intersect/gltf", "bvh_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh.py:240",
                    files["F2"]["launches"], bvh["incoherent"]),
        _kernel_row("dense_intersect/envmap", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    files["F3"]["launches"], kernels["cornell/incoherent"]),
        _kernel_row("dense_intersect/aov", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    files["F4"]["bridge.obj"]["launches"],
                    kernels["bridge/coherent"]),
        _kernel_row("bvh_intersect/aov", "bvh_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh.py:240",
                    files["F4"]["torus.glb"]["launches"], bvh["coherent"]),
        # The traces again on the viewer's modes (phase 23): V1 path
        # regularization and V2 trilinear mips (B1, the pooled wavefront),
        # V4 the preview's primary and shadow traces (B1 on CornellBox,
        # Sphere, Opacity and the bridge, B4 on the torus grid), each with
        # the timing row of its kernel phase.
        _kernel_row("dense_intersect/regularization", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    modes["V1"]["launches"], kernels["cornell/incoherent"]),
        _kernel_row("dense_intersect/trilinear", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    modes["V2"]["launches"], kernels["cornell/incoherent"]),
        _kernel_row("dense_intersect/preview", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    sum(v["launches"] for v in modes["V4"].values()
                        if v["trace"] == "B1"), kernels["cornell/camera"]),
        _kernel_row("bvh_intersect/preview", "bvh_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh.py:240",
                    sum(v["launches"] for v in modes["V4"].values()
                        if v["trace"] == "B4"), bvh["coherent"]),
        # The kernels again on the engine (phase 24): E1 the compositor's
        # path tracer on the viewer's Sphere (B3), E4 the preview, the
        # denoiser's AOV trace and the regularized wavefront (B1), each with
        # the timing row of its kernel phase.
        _kernel_row("mesh_megakernel_hier/engine", "mesh_megakernel.cu",
                    "bifrost3d_tpu/integrator/pallas_mesh.py:898",
                    engine["E1"]["launches"], hier_scenes[BRIDGE_SCENE]),
        _kernel_row("dense_intersect/engine", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    engine["E4"]["launches"], kernels["cornell/camera"]),
        # The two traces again on parallel/ (phase 25): B1 in the sharded
        # CornellBox renders (P1) and the sharded train step (P4), B4 in
        # the sharded torus grid (P2), each with the timing row of its
        # kernel phase.
        _kernel_row("dense_intersect/parallel", "dense_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_intersect.py:74",
                    parallel["launches_B1"], kernels["cornell/incoherent"]),
        _kernel_row("bvh_intersect/parallel", "bvh_intersect.cu",
                    "bifrost3d_tpu/geometry/pallas_bvh.py:240",
                    parallel["launches_B4"], bvh["incoherent"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# Phases that profile, each run alone in a process (fresh_process); and
# phases 23–28 alone (``python3 chip_smoke.py --profile viewer_modes``,
# ``engine``, ``parallel``, ``fits``, ``parity`` or ``post``), whose kernels
# build at first use.
PROFILES = {"viewer_modes": lambda device: viewer_modes_phase(
                device, device_phase()),
            "engine": lambda device: engine_phase(device, device_phase()),
            "traces": trace_device_phase,
            "pooled-dense": lambda device: pooled_frame_phase(device, "dense"),
            "pooled-clustered": lambda device: pooled_frame_phase(
                device, "clustered"),
            "pooled-vmem": lambda device: pooled_frame_phase(device, "vmem"),
            "parallel": lambda device: parallel_phase(device, device_phase()),
            "fits": lambda device: fits_phase(device, device_phase()),
            "parity": lambda device: parity_phase(device, device_phase()),
            "train": train_profile_phase,
            "clip": clip_profile_phase,
            "post": post_phase}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile"]:
        result = PROFILES[sys.argv[2]](torch.device("cuda", 0))
        print("PROFILE " + json.dumps(result), flush=True)
        sys.exit(0)
    sys.exit(main())
