"""CUDA-only tests of the PyTorch port; they need no JAX.

Each test needs a card and skips where there is none. On a machine with a
card but without JAX (whose tests/conftest.py cannot be imported there),
run them as::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bifrost3d_tpu_torch.apps import smallpt_app
from bifrost3d_tpu_torch.apps.scenes import (
    TEST_SCENES,
    create_cornell_box,
    create_material_scene,
)
from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
from bifrost3d_tpu_torch.geometry import traverse
from bifrost3d_tpu_torch.geometry.creation import make_plane, make_sphere
from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt
from bifrost3d_tpu_torch.integrator import path_tracer as pt
from bifrost3d_tpu_torch.sampling import hashes
from bifrost3d_tpu_torch.sampling.sobol import path_rng_4d
from bifrost3d_tpu_torch.scene.spheres import smallpt_scene
from bifrost3d_tpu_torch.utils import profiling
import smallpt_reference
from torch_parity import (
    assert_float64_reference_gate,
    assert_kernel_matches_plain,
    assert_smallpt_gate,
    assert_statistical_gate,
    prim_distances,
)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rays(r, seed, lo, hi, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.1, 2.0, size=r).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (o, d, t_max)]


def _sphere_soup(device):
    m = make_sphere(radius=0.5, slices=48, stacks=24)
    return torch.tensor(m.positions[m.indices], device=device)


@pytest.mark.parametrize("live", [None, 1000])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("soup", ["cornell", "sphere"])
def test_kernel_matches_plain_version(cuda, soup, bounded, live):
    if soup == "cornell":
        tris = create_cornell_box(device=cuda)[0].tri_verts
        o, d, t_max = _rays(5000, 1, (-0.45, 0.12, -0.45), (0.45, 0.45, 0.45),
                            cuda)
    else:
        tris = _sphere_soup(cuda)
        o, d, t_max = _rays(5000, 2, -0.9, 0.9, cuda)
    comp, n = dense.pack_triangles(tris)
    got = assert_kernel_matches_plain(comp, n, o, d,
                                      t_max if bounded else float("inf"), live)
    live_rays = got.prim[:live] if live is not None else got.prim
    assert int((live_rays >= 0).sum()) > live_rays.numel() // 10


def test_wrapper_validates_inputs(cuda):
    comp, n = dense.pack_triangles(_sphere_soup(cuda))
    o, d, _ = _rays(64, 3, -0.9, 0.9, cuda)
    with pytest.raises(TypeError, match="float32"):
        dense.dense_intersect_cuda(comp, n, o.double(), d.double(), 1e-4, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        dense.dense_intersect_cuda(comp[:, ::2], n // 2, o, d, 1e-4, 1.0)
    with pytest.raises(ValueError, match="n_tris"):
        dense.dense_intersect_cuda(comp, comp.shape[1] + 1, o, d, 1e-4, 1.0)
    with pytest.raises(ValueError, match=r"\[r, 3\]"):
        dense.dense_intersect_cuda(comp, n, o[:, :2], d, 1e-4, 1.0)


def test_dense_kernel_bound_and_live_count_forms(cuda):
    """Bounds as numbers, one-element or [r] tensors and the live count as
    an int, an int64 or an int32 tensor give the same hits; rays past the
    live count miss with t = inf."""
    comp, n = dense.pack_triangles(_sphere_soup(cuda))
    r, live = 5000, 1777
    o, d, t_max = _rays(r, 15, -0.9, 0.9, cuda)
    forms = [(1e-4, t_max, live),
             (torch.tensor(1e-4, device=cuda), t_max,
              torch.tensor(live, device=cuda)),
             (torch.full((r,), 1e-4, device=cuda), t_max,
              torch.tensor([live], dtype=torch.int32, device=cuda))]
    hits = [dense.dense_intersect_cuda(comp, n, o, d, lo, hi, k)
            for lo, hi, k in forms]
    for hit in hits[1:]:
        for a, b in zip(hit, hits[0]):
            assert torch.equal(a, b)
    assert bool((hits[0].prim[live:] == -1).all())
    assert bool(torch.isinf(hits[0].t[live:]).all())
    assert 0 < int((hits[0].prim >= 0).sum()) < live


def test_trace_kernels_are_one_launch_without_sync(cuda, cluster_packings):
    """After a table's first call the dense trace (the live count a device
    tensor), the cluster scan and the resident-cluster walk (closest and
    any-hit, bounds and live count on the device) each launch their kernel
    once a call and read nothing back: torch.profiler's kernels per call
    (one session: the card's trace has gone missing in a later session of
    one process), with torch's sync debug mode raising."""
    from torch.profiler import ProfilerActivity, profile, record_function
    comp, n = dense.pack_triangles(_sphere_soup(cuda))
    o, d, t_max = _rays(4096, 16, -0.9, 0.9, cuda)
    live = torch.tensor(3000, device=cuda)
    live32, t_min = live.to(torch.int32), torch.tensor(1e-4, device=cuda)
    calls = {
        "dense": lambda: dense.pallas_intersect(comp, n, o, d, 1e-4, t_max,
                                                live_count=live),
        "clustered": lambda: clustered.clustered_intersect(
            cluster_packings[0], o, d, 1e-4, t_max),
        "vmem": lambda: vmem.vmem_intersect(
            cluster_packings[1], o, d, t_min, t_max, live_count=live32),
        "vmem_any": lambda: vmem.vmem_intersect(
            cluster_packings[1], o, d, 1e-4, t_max, any_hit=True,
            live_count=live)}
    for fn in calls.values():
        fn()
    counts = (dense.launch_count, clustered.launch_count, vmem.launch_count)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for name, fn in calls.items():
                with record_function(f"calls:{name}"):
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert (dense.launch_count, clustered.launch_count,
            vmem.launch_count) == (counts[0] + 3, counts[1] + 3,
                                   counts[2] + 6)
    cuda_type = torch.autograd.DeviceType.CUDA
    events = prof.events()
    for name in calls:
        window = next(e.time_range for e in events
                      if e.name == f"calls:{name}" and e.device_type != cuda_type)
        kernels = [e.name for e in events if e.device_type == cuda_type
                   and "calls:" not in e.name and "Memcpy" not in e.name
                   and "Memset" not in e.name
                   and window.start <= e.time_range.start <= window.end]
        assert len(kernels) == 3, (name, kernels)


def test_dense_kernel_failed_launch_raises(cuda, monkeypatch):
    comp, n = dense.pack_triangles(_sphere_soup(cuda))
    o, d, _ = _rays(64, 17, -0.9, 0.9, cuda)
    before = dense.launch_count
    monkeypatch.setattr(dense, "_THREADS", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        dense.dense_intersect_cuda(comp, n, o, d, 1e-4, 1.0)
    assert dense.launch_count == before


def test_pooled_render_on_card_matches_cpu(cuda):
    """The pooled wavefront on the card (kernel trace) against the same
    frame on the CPU (plain trace), under the statistical gate."""
    res = 64
    scene, cam = create_cornell_box(device=cuda)
    cpu_scene, cpu_cam = create_cornell_box(device="cpu")
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    before = dense.launch_count
    img = pt.render_sample_pooled(scene, cam, res, res, 1, settings)
    assert dense.launch_count > before
    ref = pt.render_sample_pooled(cpu_scene, cpu_cam, res, res, 1, settings)
    assert_statistical_gate(img.cpu().numpy(), ref.numpy())


def test_render_progressive_on_card(cuda):
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    before = mega.launch_count
    img = pt.render_progressive(scene, cam, 32, 32, 2, settings,
                                high_precision=True)
    assert mega.launch_count == before + 2     # one launch per frame
    assert img.device.type == "cuda"
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.05
    assert pt.explain_render_path(scene) == "megakernel"


def _eager_progressive(scene, cam, res, accumulations, settings):
    """The progressive loop as it ran before the kernel's lerp: each frame
    through ``render_sample_fast``, the running mean in torch."""
    buffer = torch.zeros((res, res, 3), device=scene.tri_verts.device)
    for n in range(accumulations):
        frame = pt.render_sample_fast(scene, cam, res, res, n, settings)
        buffer = buffer + (frame - buffer) / (n + 1)
    return buffer


@pytest.mark.parametrize("name", ["cornell", "material_scene"])
def test_fused_progressive_is_the_eager_loop_bit_for_bit(cuda, name):
    """On the card ``render_progressive`` lerps each accumulation into the
    running mean inside the megakernel (B2 dense on CornellBox, B3 ``kHier``
    + ``kExtras`` on MaterialScene): bit for bit the eager loop's image, one
    launch an accumulation and no host sync; the Kahan branch keeps the
    eager loop and lerps nothing in the kernel."""
    make = {"cornell": create_cornell_box,
            "material_scene": create_material_scene}[name]
    scene, cam = make(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=4)
    res, n = 64, 8
    assert pt.explain_render_path(scene) == (
        "megakernel" if name == "cornell"
        else "megakernel (hier: cluster-BVH DMA trace)")
    eager = _eager_progressive(scene, cam, res, n, settings)
    pt.render_progressive(scene, cam, res, res, 1, settings)
    torch.cuda.synchronize()
    before = mega.launch_count, mega.accumulate_count
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = pt.render_progressive(scene, cam, res, res, n, settings)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (mega.launch_count, mega.accumulate_count) == (before[0] + n,
                                                          before[1] + n)
    assert profiling.counters()["integrator.pallas_mesh.accumulated_frames"] \
        == before[1] + n
    assert torch.equal(fused.view(torch.int32), eager.view(torch.int32))
    assert float(fused.mean()) > 0.0
    kahan = pt.render_progressive(scene, cam, res, res, 2, settings,
                                  high_precision=True)
    assert mega.accumulate_count == before[1] + n
    assert mega.launch_count == before[0] + n + 2
    assert bool(torch.isfinite(kahan).all())


def test_accumulator_checks_its_buffer(cuda):
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    buffer = torch.zeros((16, 16, 3), device=cuda)
    for bad in (buffer[:, :-1], buffer.double(), buffer.cpu(),
                buffer.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError, match="buffer must be"):
            mega.MegakernelAccumulator(scene, cam, 16, 16, settings, bad)
    acc = mega.MegakernelAccumulator(scene, cam, 16, 16, settings, buffer)
    acc.accumulate(0)
    frame, _ = mega.render_mesh_megakernel(scene, cam, 16, 16, 0, settings,
                                           sum_rays=False)
    assert torch.equal(buffer, frame)


def _kernel_vs_plain(scene, cam, res, accumulation, settings):
    """One frame through the kernel (its own camera lanes, one launch) and
    through the plain version (the torch lanes in raster order) → (kernel
    image [n, 3], kernel rays [n], plain image [n, 3], plain rays [n]),
    pixels in raster order on both sides."""
    args = mega.megakernel_frame_inputs(scene, cam, res, res, accumulation,
                                        settings)
    before = mega.launch_count
    img, rays = mega.mesh_megakernel_cuda(*args)
    torch.cuda.synchronize()
    assert mega.launch_count == before + 1
    assert img.shape == (res, res, 3) and rays.shape == (res * res,)
    r, g, b, ref_rays = mega.mesh_megakernel_reference(*mega.megakernel_inputs(
        scene, cam, res, res, accumulation, settings))
    return img.reshape(-1, 3), rays, torch.stack([r, g, b], dim=-1), ref_rays


def _assert_kernel_matches_plain(scene, cam, res, settings, min_mean=0.01):
    img, rays, ref, ref_rays = _kernel_vs_plain(scene, cam, res, 1, settings)
    img = img.cpu().numpy()
    assert_statistical_gate(img, ref.cpu().numpy(), KERNEL_FLIPS, KERNEL_MEAN)
    rays, ref_rays = float(rays.sum()), float(ref_rays.sum())
    assert abs(rays - ref_rays) <= 0.02 * ref_rays
    assert img.mean() > min_mean


@pytest.mark.parametrize("accumulation", [0, 1, 7])
def test_megakernel_rng_is_bit_exact(cuda, accumulation):
    rng = np.random.default_rng(accumulation)
    hashes = torch.tensor(rng.integers(0, 2**32, 4096), device=cuda)
    dims = torch.tensor(rng.integers(0, 64, 4096), device=cuda)
    got = mega.rng_probe(accumulation, hashes, dims)
    ref = path_rng_4d(accumulation, hashes, dims)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


# The kernel and its plain version share the RNG bit for bit and differ only
# by nvcc's FMA contraction: measured 0.00-0.02% of pixels off on the H100,
# so the budget is 0.2% and means within 0.5%, not the 3% / 2% of two
# different paths.
KERNEL_FLIPS, KERNEL_MEAN = 0.002, 0.005


@pytest.mark.parametrize("name", ["cornell", "coated", "directional"])
def test_megakernel_matches_plain_version(cuda, name):
    res = 64
    if name == "cornell":
        scene, cam = create_cornell_box(device=cuda)
    else:
        scene, cam = TEST_SCENES[name](device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    _assert_kernel_matches_plain(scene, cam, res, settings)


@pytest.mark.parametrize("tile", [None, (8, 4)])
@pytest.mark.parametrize("accumulation", [0, 1, 7])
def test_megakernel_camera_lanes_match_torch(cuda, tile, accumulation):
    """The kernel's own camera lanes against path_tracer._camera_lanes:
    every pixel written once, the pcg2d hash bit for bit, origin and
    direction within 1e-6 of their length (nvcc contracts the 4 x 4 product
    and the rotation), the same active lanes."""
    w, h = 64, 48
    _, cam = create_cornell_box(aspect=w / h, device=cuda)
    frame = mega.CameraFrame(cam, w, h, tile)
    hashes, origin, direction, active = mega.camera_probe(frame, accumulation)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(origin).all() & torch.isfinite(direction).all())
    flat = torch.arange(w * h, device=cuda)
    lanes = pt._camera_lanes(cam, flat % w, flat // w, w, h, accumulation,
                             torch.ones_like(flat, dtype=torch.bool))
    assert torch.equal(hashes, lanes.pixel_hash)
    for got, ref in ((origin, lanes.origin), (direction, lanes.direction)):
        err = (got - ref).abs().amax(dim=-1)
        assert bool((err <= 1e-6 * ref.norm(dim=-1)).all()), float(err.max())
    assert torch.equal(active, lanes.active)


@pytest.mark.parametrize("any_hit", [False, True])
def test_megakernel_trace_probe_matches_dense_kernel(cuda, any_hit):
    """The megakernel's chunk-culled dense trace against the dense trace
    kernel on the same table: the same prim off ties, t/u/v bit for bit
    where prim agrees; with any_hit the same occlusion."""
    from bifrost3d_tpu_torch.apps.scenes import SCENES
    sphere = SCENES["Sphere"](device=cuda)[0]
    rng = np.random.default_rng(12)
    rand = (rng.uniform(-1.0, 1.0, size=(1024, 1, 3))
            + rng.normal(scale=0.15, size=(1024, 3, 3))).astype(np.float32)
    for tris in (sphere.tri_verts, torch.tensor(rand, device=cuda)):
        table = mega.dense_table(tris)
        n = int(tris.shape[0])
        o, d, t_max = _rays(8192, 13, -1.2, 1.2, cuda)
        comp, _ = dense.pack_triangles(tris)
        ref = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, t_max)
        got = mega.trace_probe(table, n, o, d, 1e-4, float("inf") if not
                               any_hit else 2.0, any_hit)
        if any_hit:
            ref = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, 2.0)
            assert torch.equal(got.prim >= 0, ref.prim >= 0)
            continue
        ref = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, float("inf"))
        same = got.prim == ref.prim
        tie = ~same & ((got.t - ref.t).abs() <= 1e-6 * ref.t.abs())
        assert bool((same | tie).all())
        for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
            assert torch.equal(a[same], b[same])
        assert int((got.prim >= 0).sum()) > 800


def test_megakernel_frame_makes_no_host_sync(cuda):
    """After a scene's first frame, render_sample_fast reads nothing back
    from the card (torch's sync debug mode raises on a synchronising op)
    and launches the megakernel once."""
    scene, cam = TEST_SCENES["mid_size"](device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    pt.render_sample_fast(scene, cam, 32, 32, 0, settings)
    before = mega.launch_count
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = pt.render_sample_fast(scene, cam, 32, 32, 1, settings)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert mega.launch_count == before + 1
    assert float(img.mean()) > 0.0


# Run in a process of its own: torch.profiler on the card has lost the
# card's trace in a later session of one process, and this test holds two
# sessions after the profiling tests above.
_SPAN_EVENTS = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.integrator import path_tracer as pt
from bifrost3d_tpu_torch.post.pipeline import process
from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
scene, cam = create_cornell_box(device="cuda")
settings = pt.settings_for_scene(scene, max_bounce_count=2)
pt.render_sample_fast(scene, cam, 64, 64, 0, settings)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    process(pt.render_progressive(scene, cam, 64, 64, 2, settings),
            CameraEffectsSettings.preset())
    torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as frame:
    pt.render_sample_fast(scene, cam, 64, 64, 1, settings)
    torch.cuda.synchronize()
device = torch.autograd.DeviceType.CUDA
events = prof.profiler.kineto_results.events()
print(json.dumps({
    "card": [e.name() for e in events if e.device_type() == device],
    "host": [e.name() for e in events if e.device_type() != device
             and e.name().startswith("b3d.")],
    "kernels": [e.name() for e in frame.profiler.kineto_results.events()
                if e.device_type() == device]}))
"""


def test_spans_leave_no_device_events(cuda):
    """Under a CPU + CUDA profiler session a progressive render and its post
    leave their ``b3d.`` spans on the host only (no device-side copy that
    a trace would count as a launch or as busy time), and a frame of the
    product dispatch is the megakernel's one launch: no sum of the ray
    tally it drops."""
    proc = subprocess.run([sys.executable, "-c", _SPAN_EVENTS],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    card, kernels = got["card"], got["kernels"]
    host = {}
    for name in got["host"]:
        host[name] = host.get(name, 0) + 1
    assert not [n for n in card if n.startswith("b3d.")]
    assert host["b3d.render.progressive"] == 1
    assert host["b3d.render.frame"] == host["b3d.megakernel.launch"] == 2
    assert host["b3d.post.process"] == host["b3d.post.tonemap"] == 1
    assert len(kernels) == 1 and "mesh_megakernel" in kernels[0], kernels


def test_smallpt_spans_leave_no_device_events(cuda):
    """The SmallPT app's spans stay on the host under a CPU + CUDA session:
    one ``b3d.smallpt.progressive`` a call, a ``.frame`` and a ``.launch``
    an accumulation, and on the card one kernel an accumulation."""
    from torch.profiler import ProfilerActivity, profile
    smallpt_app.render_progressive(64, 48, 1, quiet=True, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        smallpt_app.render_progressive(64, 48, 2, quiet=True, device=cuda)
    device = torch.autograd.DeviceType.CUDA
    host, card = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device:
            card.append(e.name())
        elif e.name().startswith("b3d."):
            host[e.name()] = host.get(e.name(), 0) + 1
    assert not [n for n in card if n.startswith("b3d.")]
    assert host == {"b3d.smallpt.progressive": 1, "b3d.smallpt.frame": 2,
                    "b3d.smallpt.launch": 2}
    assert len([n for n in card if "smallpt_kernel" in n]) == 2, card


def test_megakernel_sees_in_place_writes(cuda):
    """A frame after an in-place write to the scene's tensors equals a frame
    of a freshly built scene with the same values."""
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    pt.render_sample_fast(scene, cam, 32, 32, 1, settings)
    fresh, _ = create_cornell_box(device=cuda)
    with torch.no_grad():
        scene.materials.tint.mul_(0.5)
        scene.tri_verts.add_(0.01)
    fresh = fresh._replace(
        materials=fresh.materials._replace(tint=fresh.materials.tint * 0.5),
        tri_verts=fresh.tri_verts + 0.01)
    got = pt.render_sample_fast(scene, cam, 32, 32, 1, settings)
    ref = pt.render_sample_fast(fresh, cam, 32, 32, 1, settings)
    torch.testing.assert_close(got, ref, rtol=0.0, atol=0.0)


def test_megakernel_failed_launch_raises(cuda, monkeypatch):
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    args = mega.megakernel_frame_inputs(scene, cam, 16, 16, 0, settings)
    before = mega.launch_count
    # 2048 threads per block is past the card's limit of 1024: a real
    # cudaErrorInvalidConfiguration from the launch.
    monkeypatch.setattr(mega, "_THREADS", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        mega.mesh_megakernel_cuda(*args)
    assert mega.launch_count == before
    with pytest.raises(ValueError, match="n_tris"):
        mega.mesh_megakernel_cuda(*args[:-1], args[-1]._replace(n_tris=2000))
    with pytest.raises(ValueError, match="camera rotation"):
        bad = args[6].camera._replace(transform=args[6].camera.transform._replace(
            rotation=args[6].camera.transform.rotation[:3]))
        mega.mesh_megakernel_cuda(*args[:6], args[6]._replace(camera=bad),
                                  *args[7:])


# -- the SmallPT megakernel --------------------------------------------------------

@pytest.mark.parametrize("accumulation", [1, 2, 7])
def test_smallpt_kernel_matches_plain_version(cuda, accumulation):
    """Same LCG bits on both sides; nvcc's FMA contraction flips a few
    grazing hits on the 1e5-radius walls and roulette draws (0.63% of
    pixels at 1024 x 768 on an H100), so the gate is that of
    tests/test_smallpt.py: under 2% of pixels off by > 1e-4, means within
    2% (at 12,288 pixels one flipped path to the light moves the mean by
    0.1%)."""
    scene = smallpt_scene(device=cuda)
    before = spt.launch_count
    got = spt.render_smallpt_megakernel(scene, 128, 96, accumulation)
    torch.cuda.synchronize()
    assert spt.launch_count == before + 1
    assert got.shape == (96, 128, 3) and got.device.type == "cuda"
    ref = spt.smallpt_megakernel_reference(scene, 128, 96, accumulation)
    assert_smallpt_gate(got.cpu().numpy(), ref.cpu().numpy())
    assert float(got.mean()) > 0.1


@pytest.mark.parametrize("accumulation", [1, 2, 7])
def test_smallpt_rng_is_bit_exact(cuda, accumulation):
    rng = np.random.default_rng(accumulation)
    width, steps = 1024, 32
    x = torch.tensor(rng.integers(0, width, 4096), device=cuda)
    y = torch.tensor(rng.integers(0, 768, 4096), device=cuda)
    states, floats = spt.rng_probe(x, y, width, accumulation, steps)
    index = hashes.u32((y * 2 + (accumulation >> 1) % 2) * (width * 2)
                       + x * 2 + accumulation % 2)
    state = hashes.jenkins_hash(index) ^ int(
        hashes.reverse_bits(hashes.u32(accumulation)))
    for k in range(steps):
        state, u = hashes.lcg_next(state)
        assert torch.equal(states[k], state)
        assert torch.equal(floats[k].view(torch.int32), u.view(torch.int32))


def test_smallpt_failed_launch_raises(cuda, monkeypatch):
    scene = smallpt_scene(device=cuda)
    before = spt.launch_count
    # 2048 threads per block is past the card's limit of 1024.
    monkeypatch.setattr(spt, "_THREADS", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        spt.smallpt_megakernel_cuda(scene, 16, 16, 1)
    assert spt.launch_count == before
    many = type(scene)(*(torch.cat([f] * 8) for f in scene))    # 72 spheres
    with pytest.raises(ValueError, match="spheres outside"):
        spt.smallpt_megakernel_cuda(many, 16, 16, 1)


def test_smallpt_app_on_card(cuda):
    before = spt.launch_count
    img = smallpt_app.render_progressive(64, 48, 4, quiet=True, device=cuda)
    assert spt.launch_count == before + 4      # one launch per frame
    assert img.device.type == "cuda" and img.shape == (48, 64, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.1


def test_smallpt_app_matches_float64_reference(cuda):
    """B5 through the app (``smallpt_megakernel_accumulate``, one launch a
    frame) against the float64 numpy reference at tests/test_smallpt.py's
    64 x 48 x 32, with its gates: relative RMS < 0.20, > 80% of the pixels
    within 2%, means within 3%."""
    before = spt.launch_count
    img = smallpt_app.render_progressive(64, 48, 32, quiet=True, device=cuda)
    assert spt.launch_count == before + 32
    assert_float64_reference_gate(img.cpu().numpy(),
                                  smallpt_reference.render(64, 48, 32))


@pytest.mark.parametrize("accumulation", [1, 2, 3])
def test_smallpt_regeneration_matches_plain_version_at_an_odd_size(
        cuda, accumulation):
    """37 x 23 pixels: the last claim round of the persistent lanes is
    ragged. Per frame the flip share of the gate; the means over the three
    frames (one flipped path to the light moves an 851-pixel frame's mean
    by percents)."""
    scene = smallpt_scene(device=cuda)
    w, h = 37, 23
    got = spt.smallpt_megakernel_cuda(scene, w, h, accumulation)
    ref = spt.smallpt_megakernel_reference(scene, w, h, accumulation)
    assert_smallpt_gate(got.cpu().numpy(), ref.cpu().numpy(), mean_budget=None)
    means = [(float(spt.smallpt_megakernel_cuda(scene, w, h, a).mean()),
              float(spt.smallpt_megakernel_reference(scene, w, h, a).mean()))
             for a in (1, 2, 3)]
    got_mean, ref_mean = np.mean(means, axis=0)
    np.testing.assert_allclose(got_mean, ref_mean, rtol=0.02)


def test_smallpt_consecutive_launches_are_identical(cuda):
    """The pixel counter is zeroed before every launch: a second launch
    renders every pixel again, the same bits."""
    scene = smallpt_scene(device=cuda)
    first = spt.smallpt_megakernel_cuda(scene, 128, 96, 2).clone()
    second = spt.smallpt_megakernel_cuda(scene, 128, 96, 2)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert bool(torch.isfinite(first).all())


def test_smallpt_accumulate_is_the_frame_and_the_torch_lerp(cuda):
    """The kernel's running mean is bit for bit the frame lerped by torch on
    the card, ``buffer + (frame - buffer) / n``."""
    scene = smallpt_scene(device=cuda)
    w, h = 64, 48
    buffer = torch.zeros((h, w, 3), device=cuda)
    ref = torch.zeros((h, w, 3), device=cuda)
    before = spt.launch_count
    for n in (1, 2, 3):
        spt.smallpt_megakernel_accumulate(scene, w, h, n, buffer)
        frame = spt.smallpt_megakernel_cuda(scene, w, h, n)
        ref = ref + (frame - ref) / n
        assert torch.equal(buffer.view(torch.int32), ref.view(torch.int32)), n
    assert spt.launch_count == before + 6
    with pytest.raises(ValueError, match="buffer must be"):
        spt.smallpt_megakernel_accumulate(scene, w, h, 1, buffer[:, :-1])


# -- the BVH trace kernel -----------------------------------------------------------

def _soup_16k(device):
    """The 16,130-triangle sphere + floor soup both trace kernels can take."""
    sphere = make_sphere(radius=0.5, slices=128, stacks=64)
    floor = make_plane(size=4.0)
    floor = floor._replace(positions=floor.positions
                           + np.asarray([0, -0.5, 0], np.float32))
    soup = np.concatenate([m.positions[m.indices] for m in (sphere, floor)])
    return torch.tensor(soup, dtype=torch.float32, device=device)


def _assert_hits_agree(got, ref, min_hits=0.1):
    """prim equal except between candidates whose t agree to 1e-6
    relative (ties), on >= 99.9% of rays; t within rtol 1e-5 where equal;
    more than ``min_hits`` of the rays hit."""
    same = got.prim == ref.prim
    both = (got.prim >= 0) & (ref.prim >= 0)
    tie = ~same & both & ((got.t - ref.t).abs() <= 1e-6 * ref.t.abs())
    assert float((same | tie).float().mean()) >= 0.999
    hit = same & both
    assert int(hit.sum()) > hit.numel() * min_hits
    torch.testing.assert_close(got.t[hit], ref.t[hit], rtol=1e-5, atol=0.0)


@pytest.fixture(scope="module")
def packed_soup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    soup = _soup_16k(torch.device("cuda"))
    return soup, hier.pack_hierarchical(soup)


@pytest.mark.parametrize("live", [None, 1000])
@pytest.mark.parametrize("bounded", [False, True])
def test_bvh_kernel_matches_plain_version(cuda, packed_soup, bounded, live):
    _, packed = packed_soup
    o, d, t_max = _rays(5000, 4, -0.9, 0.9, cuda)
    bound = t_max if bounded else float("inf")
    live_count = None if live is None else torch.tensor(live, device=cuda)
    before = hier.launch_count
    got = hier.hierarchical_intersect(packed, o, d, 1e-4, bound,
                                      live_count=live_count)
    torch.cuda.synchronize()
    assert hier.launch_count == before + 1
    ref = hier.hierarchical_intersect_reference(packed, o, d, 1e-4, bound,
                                                live_count=live)
    rows = slice(0, live)
    _assert_hits_agree(type(got)(*(f[rows] for f in got)),
                       type(ref)(*(f[rows] for f in ref)))
    if live is not None:
        assert bool((got.prim[live:] == -1).all())
        assert bool(torch.isinf(got.t[live:]).all())


def test_bvh_kernel_any_hit_and_sorted(cuda, packed_soup):
    _, packed = packed_soup
    o, d, t_max = _rays(5000, 5, -0.9, 0.9, cuda)
    ref = hier.hierarchical_intersect_reference(packed, o, d, 1e-4, t_max)
    occluded = hier.hierarchical_intersect(packed, o, d, 1e-4, t_max,
                                           any_hit=True).prim >= 0
    assert float((occluded == (ref.prim >= 0)).float().mean()) >= 0.999
    assert 0 < int(occluded.sum()) < 5000
    srt = hier.hierarchical_intersect_sorted(packed, o, d, 1e-4, t_max)
    _assert_hits_agree(srt, ref)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_bound_and_live_count_forms(cuda, packed_soup, any_hit):
    """Bounds as numbers, one-element tensors or [r] tensors, and the live
    count as an int, an int64 or an int32 tensor, give the same hits; rays
    past the live count miss with t = inf; the live prefix agrees with the
    plain version."""
    _, packed = packed_soup
    r, live = 5000, 1777
    o, d, t_max = _rays(r, 14, -0.9, 0.9, cuda)
    forms = [(1e-4, t_max, live),
             (torch.tensor(1e-4, device=cuda), t_max,
              torch.tensor(live, device=cuda)),
             (torch.full((r,), 1e-4, device=cuda), t_max,
              torch.tensor([live], dtype=torch.int32, device=cuda))]
    hits = [hier.hierarchical_intersect_cuda(packed, o, d, lo, hi, any_hit, n)
            for lo, hi, n in forms]
    for hit in hits[1:]:
        assert torch.equal(hit.prim, hits[0].prim)
        assert torch.equal(hit.t, hits[0].t)
    assert bool((hits[0].prim[live:] == -1).all())
    assert bool(torch.isinf(hits[0].t[live:]).all())
    ref = hier.hierarchical_intersect_reference(packed, o, d, 1e-4, t_max,
                                                any_hit=any_hit,
                                                live_count=live)
    got = type(ref)(*(f[:live] for f in hits[0]))
    ref = type(ref)(*(f[:live] for f in ref))
    if any_hit:
        assert float(((got.prim >= 0) == (ref.prim >= 0)).float().mean()) \
            >= 0.999
    else:
        _assert_hits_agree(got, ref)


def test_bvh_kernel_matches_dense_kernel(cuda, packed_soup):
    soup, packed = packed_soup
    comp, n = dense.pack_triangles(soup)
    assert n == 16130
    o, d, _ = _rays(5000, 6, -0.9, 0.9, cuda)
    ref = dense.pallas_intersect(comp, n, o, d, 1e-4, float("inf"))
    got = hier.hierarchical_intersect(packed, o, d, 1e-4, float("inf"))
    _assert_hits_agree(got, ref)


def test_bvh_kernel_failed_launch_raises(cuda, packed_soup, monkeypatch):
    _, packed = packed_soup
    o, d, _ = _rays(64, 7, -0.9, 0.9, cuda)
    before = hier.launch_count
    monkeypatch.setattr(hier, "_THREADS", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        hier.hierarchical_intersect_cuda(packed, o, d, 1e-4, 1.0)
    assert hier.launch_count == before
    monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        hier.hierarchical_intersect_cuda(packed, o.double(), d.double(),
                                         1e-4, 1.0)
    with pytest.raises(ValueError, match=r"\[T, 12\]"):
        hier.hierarchical_intersect_cuda(
            packed._replace(tri_components=packed.tri_components[:, :9]),
            o, d, 1e-4, 1.0)


def test_bvh_path_render_on_card_matches_cpu(cuda, monkeypatch):
    """A small scene forced onto the BVH path: the pooled wavefront on the
    card (BVH kernel, sorted pool, live prefix as a device tensor) against
    the same frame on the CPU (plain traversal)."""
    monkeypatch.setattr(traverse, "PALLAS_MAX_TRIS", 100)
    res = 64
    scene, cam = TEST_SCENES["coated"](device=cuda)
    cpu_scene, cpu_cam = TEST_SCENES["coated"](device="cpu")
    assert scene.tri_clustered is not None and scene.tri_components is None
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    assert settings.sort_rays_every == 1
    before, dense_before = hier.launch_count, dense.launch_count
    img = pt.render_sample_pooled(scene, cam, res, res, 1, settings)
    assert hier.launch_count > before and dense.launch_count == dense_before
    ref = pt.render_sample_pooled(cpu_scene, cpu_cam, res, res, 1, settings)
    assert_statistical_gate(img.cpu().numpy(), ref.numpy())


# -- the cluster-scan and resident-cluster trace kernels ---------------------------

@pytest.fixture(scope="module")
def cluster_packings(packed_soup):
    soup, _ = packed_soup
    return clustered.pack_clustered(soup), vmem.pack_vmem(soup)


@pytest.mark.parametrize("bounded", [False, True])
def test_clustered_kernel_matches_plain_version(cuda, packed_soup,
                                                cluster_packings, bounded):
    soup, _ = packed_soup
    packed, _ = cluster_packings
    o, d, t_max = _rays(5000, 8, -0.9, 0.9, cuda)     # not a multiple of 256
    bound = t_max if bounded else float("inf")
    before = clustered.launch_count
    got = clustered.clustered_intersect(packed, o, d, 1e-4, bound)
    torch.cuda.synchronize()
    assert clustered.launch_count == before + 1
    _assert_hits_agree(got, clustered.clustered_intersect_reference(
        packed, o, d, 1e-4, bound))
    comp, n = dense.pack_triangles(soup)
    _assert_hits_agree(got, dense.pallas_intersect(comp, n, o, d, 1e-4, bound))


@pytest.mark.parametrize("live", [None, 1000])
@pytest.mark.parametrize("bounded", [False, True])
def test_vmem_kernel_matches_plain_version(cuda, cluster_packings, bounded,
                                           live):
    _, packed = cluster_packings
    o, d, t_max = _rays(5000, 9, -0.9, 0.9, cuda)     # not a multiple of 32
    bound = t_max if bounded else float("inf")
    live_count = None if live is None else torch.tensor(live, device=cuda)
    before = vmem.launch_count
    got = vmem.vmem_intersect(packed, o, d, 1e-4, bound,
                              live_count=live_count)
    torch.cuda.synchronize()
    assert vmem.launch_count == before + 1
    ref = vmem.vmem_intersect_reference(packed, o, d, 1e-4, bound,
                                        live_count=live)
    # The live prefix is honoured by whole groups of 32 rays.
    covered = None if live is None else -(-live // vmem.GROUP_R) * vmem.GROUP_R
    rows = slice(0, covered)
    _assert_hits_agree(type(got)(*(f[rows] for f in got)),
                       type(ref)(*(f[rows] for f in ref)))
    if live is not None:
        assert bool((got.prim[covered:] == -1).all())
        assert bool(torch.isinf(got.t[covered:]).all())


def _assert_any_hits_agree(got, ref, tris, o, d):
    """Any-hit hits under the closest-hit gate, each at the distance of the
    triangle it names (prim_distances)."""
    _assert_hits_agree(prim_distances(got, tris, o, d),
                       prim_distances(ref, tris, o, d), min_hits=0.0)


def test_vmem_kernel_any_hit_and_bvh_kernel(cuda, packed_soup,
                                            cluster_packings):
    """Closest hits against the BVH kernel's; any-hit occlusion against the
    BVH kernel's closest hits, and its prim against the plain walk's any-hit
    under the closest-hit gate."""
    soup, tree = packed_soup
    _, packed = cluster_packings
    o, d, t_max = _rays(5000, 10, -0.9, 0.9, cuda)
    ref = hier.hierarchical_intersect(tree, o, d, 1e-4, t_max)
    _assert_hits_agree(vmem.vmem_intersect(packed, o, d, 1e-4, t_max), ref)
    any_hit = vmem.vmem_intersect(packed, o, d, 1e-4, t_max, any_hit=True)
    occluded = any_hit.prim >= 0
    assert float((occluded == (ref.prim >= 0)).float().mean()) >= 0.999
    assert 0 < int(occluded.sum()) < 5000
    _assert_any_hits_agree(any_hit, vmem.vmem_intersect_reference(
        packed, o, d, 1e-4, t_max, any_hit=True), soup, o, d)


@pytest.mark.parametrize("any_hit", [False, True])
def test_vmem_kernel_bound_and_live_count_forms(cuda, packed_soup,
                                                cluster_packings, any_hit):
    """Bounds as numbers, one device value or [r] tensors, and the live
    count as an int, an int32 or an int64 tensor, give the same hits, and
    the plain version's: closest hits under the gate; any-hit's occlusion
    and prim (the leaf's nearest hit, then the ray frozen) on >= 99.9% of
    rays, u and v within rtol 1e-4, atol 1e-5 where prim agrees, and its
    prim under the closest-hit gate (and the plain model of the kernel's
    cull bit for bit equal to the plain walk); whole groups past the live
    count miss with t = inf."""
    packed = cluster_packings[1]
    r, live = 5000, 1777
    covered = -(-live // vmem.GROUP_R) * vmem.GROUP_R
    o, d, t_max = _rays(r, 19, -0.9, 0.9, cuda)
    forms = [(1e-4, t_max, live),
             (torch.tensor(1e-4, device=cuda), t_max,
              torch.tensor([live], dtype=torch.int32, device=cuda)),
             (torch.full((r,), 1e-4, device=cuda), t_max,
              torch.tensor(live, device=cuda))]
    hits = [vmem.vmem_intersect_cuda(packed, o, d, lo, hi, any_hit, n)
            for lo, hi, n in forms]
    for hit in hits[1:]:
        for a, b in zip(hit, hits[0]):
            assert torch.equal(a, b)
    assert bool((hits[0].prim[covered:] == -1).all())
    assert bool(torch.isinf(hits[0].t[covered:]).all())
    ref = vmem.vmem_intersect_reference(packed, o, d, 1e-4, t_max,
                                        any_hit=any_hit, live_count=live)
    model = vmem.vmem_intersect_reference(packed, o, d, 1e-4, t_max,
                                          any_hit=any_hit, live_count=live,
                                          culled=True)
    got = type(ref)(*(f[:covered] for f in hits[0]))
    for a, b in zip(model, ref):
        assert torch.equal(a, b)
    ref = type(ref)(*(f[:covered] for f in ref))
    if any_hit:
        assert float(((got.prim >= 0) == (ref.prim >= 0))
                     .float().mean()) >= 0.999
        assert 0 < int((got.prim >= 0).sum()) < covered
        same = got.prim == ref.prim
        assert float(same.float().mean()) >= 0.999
        hit = same & (ref.prim >= 0)
        for a, b in ((got.u, ref.u), (got.v, ref.v)):
            torch.testing.assert_close(a[hit], b[hit], rtol=1e-4, atol=1e-5)
        _assert_any_hits_agree(got, ref, packed_soup[0], o[:covered],
                               d[:covered])
    else:
        _assert_hits_agree(got, ref)


def test_vmem_kernel_hit_is_one_allocation(cuda, cluster_packings):
    """The Hit's four fields are views of one [4, r] allocation, misses t =
    inf, prim = -1, u = v = 0."""
    o, d, t_max = _rays(3000, 20, -0.9, 0.9, cuda)
    hit = vmem.vmem_intersect_cuda(cluster_packings[1], o, d, 1e-4, t_max)
    base = hit.t.untyped_storage().data_ptr()
    assert all(f.untyped_storage().data_ptr() == base for f in hit)
    assert [f.data_ptr() - base for f in hit] == [0, 12000, 24000, 36000]
    assert hit.prim.dtype == torch.int32
    miss = hit.prim < 0
    assert 0 < int(miss.sum()) < 3000
    assert bool(torch.isinf(hit.t[miss]).all())
    assert not bool(hit.u[miss].any()) and not bool(hit.v[miss].any())


@pytest.mark.parametrize("module, name", [(clustered, "clustered_intersect"),
                                          (vmem, "vmem_intersect")])
def test_cluster_kernels_failed_launch_raises(cuda, cluster_packings,
                                              monkeypatch, module, name):
    packed = cluster_packings[0 if module is clustered else 1]
    o, d, _ = _rays(64, 11, -0.9, 0.9, cuda)
    launch = getattr(module, name + "_cuda")
    before = module.launch_count
    monkeypatch.setattr(module, "_THREADS", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch(packed, o, d, 1e-4, 1.0)
    assert module.launch_count == before
    monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        launch(packed, o.double(), d.double(), 1e-4, 1.0)
    # A packing made on the CPU handed to rays on the card raises.
    on_cpu = type(packed)(*(f.cpu() if isinstance(f, torch.Tensor) else f
                            for f in packed))
    with pytest.raises(ValueError, match="is on cpu"):
        launch(on_cpu, o, d, 1e-4, 1.0)


def test_cluster_scan_cull_model_and_forms(cuda, cluster_packings):
    """The cluster scan takes rays as they are and its bounds as numbers or
    tensors; its hits are within the gate of the plain version and of the
    plain model of its cull, which agree bit for bit."""
    packed = cluster_packings[0]
    o, d, t_max = _rays(5000, 18, -0.9, 0.9, cuda)
    got = clustered.clustered_intersect(packed, o, d, 1e-4, t_max)
    again = clustered.clustered_intersect(
        packed, o, d, torch.full((5000,), 1e-4, device=cuda), t_max)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = clustered.clustered_intersect_reference(packed, o, d, 1e-4, t_max)
    model = clustered.clustered_intersect_reference(packed, o, d, 1e-4, t_max,
                                                    culled=True)
    for a, b in zip(model, ref):
        assert torch.equal(a, b)
    _assert_hits_agree(got, ref)


@pytest.mark.parametrize("packing", ["clustered", "vmem"])
def test_cluster_packings_render_on_card_match_cpu(cuda, packing):
    """A wavefront frame with tri_clustered set to each packing: the right
    kernel launches, the dense and BVH kernels do not, and the frame passes
    the statistical gate against the CPU's dense trace."""
    res = 64
    scene, cam = TEST_SCENES["coated"](device=cuda)
    cpu_scene, cpu_cam = TEST_SCENES["coated"](device="cpu")
    if packing == "clustered":
        module, packed = clustered, clustered.pack_clustered(scene.tri_verts,
                                                             scene.bvh)
    else:
        module, packed = vmem, vmem.pack_vmem(scene.tri_verts, scene.bvh)
    scene = scene._replace(tri_clustered=packed, tri_components=None)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    before = module.launch_count
    others = hier.launch_count, dense.launch_count
    img = pt.render_sample_pooled(scene, cam, res, res, 1, settings)
    assert module.launch_count > before
    assert (hier.launch_count, dense.launch_count) == others
    ref = pt.render_sample_pooled(cpu_scene, cpu_cam, res, res, 1,
                                  pt.settings_for_scene(cpu_scene,
                                                        max_bounce_count=2))
    assert_statistical_gate(img.cpu().numpy(), ref.numpy())


# -- the megakernel's BVH branch -----------------------------------------------------

@pytest.mark.parametrize("name", ["mid_size", "hier_bridge_15k"])
def test_hier_megakernel_matches_plain_version(cuda, name):
    res = 64
    scene, cam = TEST_SCENES[name](device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    assert pt.explain_render_path(scene, settings) == \
        "megakernel (hier: cluster-BVH DMA trace)"
    args = mega.megakernel_frame_inputs(scene, cam, res, res, 1, settings)
    assert args[-1].hier and isinstance(args[0], hier.HierTriangles)
    assert args[6].tile == mega.HIER_PIXEL_TILE
    _assert_kernel_matches_plain(scene, cam, res, settings)


def test_hier_megakernel_frame_matches_wavefront(cuda, monkeypatch):
    """render_sample_fast on a 2,494-triangle scene: one megakernel launch,
    no trace-kernel launch, lanes in pixel tiles put back in raster order,
    under the statistical gate against the pooled wavefront."""
    res = 64
    scene, cam = TEST_SCENES["mid_size"](device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    before = mega.launch_count, dense.launch_count, hier.launch_count
    img = pt.render_sample_fast(scene, cam, res, res, 1, settings)
    torch.cuda.synchronize()
    assert (mega.launch_count, dense.launch_count, hier.launch_count) == (
        before[0] + 1, before[1], before[2])
    ref = pt.render_sample_pooled(scene, cam, res, res, 1, settings)
    assert_statistical_gate(img.cpu().numpy(), ref.cpu().numpy())
    # Tiled lanes and raster lanes render the same pixels.
    monkeypatch.setattr(mega, "HIER_PIXEL_TILE", None)
    raster = pt.render_sample_fast(scene, cam, res, res, 1, settings)
    torch.testing.assert_close(img, raster, rtol=0.0, atol=0.0)


def test_hier_megakernel_wrapper_validates(cuda):
    scene, cam = TEST_SCENES["mid_size"](device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    args = mega.megakernel_frame_inputs(scene, cam, 16, 16, 0, settings)
    with pytest.raises(TypeError, match="packed BVH"):
        mega.mesh_megakernel_cuda(*args[:-1], args[-1]._replace(hier=False))
    with pytest.raises(ValueError, match="n_tris"):
        mega.mesh_megakernel_cuda(*args[:-1], args[-1]._replace(n_tris=7))
    deep = args[0]._replace(max_depth=64)
    with pytest.raises(ValueError, match="exceeds the kernel stack"):
        mega.mesh_megakernel_cuda(deep, *args[1:])


def _walk_trees(device):
    """Two trees the megakernel's walk takes: 4 tori of the grid (36,864
    triangles) and the 14,606-triangle bridge, and seeded rays from inside
    its box."""
    from bifrost3d_tpu_torch.apps.scenes import torus_grid_mesh
    torus = torus_grid_mesh(count=4)
    bridge, _ = TEST_SCENES["hier_bridge_15k"](device=device)
    for name, tris, lo, hi in (
            ("torus", torch.tensor(torus.positions[torus.indices],
                                   device=device),
             (-13.0, -1.0, -13.0), (-9.0, 1.0, -3.0)),
            ("bridge", bridge.tri_verts, (-1.5, -0.4, -1.5), (1.5, 1.0, 1.5))):
        tree = hier.pack_hierarchical(tris)
        o, d, _ = _rays(8192, 23, lo, hi, device)
        yield name, tree, o, d


def test_hier_walk_probe_is_bit_equal_to_the_bvh_kernel(cuda):
    """The megakernel's build of the walk over child records gives the BVH
    kernel's bits: t, prim, u, v, closest hit and any-hit."""
    inf = float("inf")
    for name, tree, o, d in _walk_trees(cuda):
        got = mega.hier_trace_probe(tree, o, d, 1e-4, inf)
        ref = hier.hierarchical_intersect_cuda(tree, o, d, 1e-4, inf)
        assert float((ref.prim >= 0).float().mean()) > 0.1, name
        # Any-hit within a shortened hit distance (mostly misses), and
        # unbounded: the first valid hit in walk order, equal only when both
        # walks visit the leaves in the same order.
        t_max = torch.where(ref.prim >= 0, ref.t * 0.75, 5.0).contiguous()
        pairs = [(got, ref)]
        for bound in (t_max, inf):
            pairs.append((
                mega.hier_trace_probe(tree, o, d, 1e-4, bound, any_hit=True),
                hier.hierarchical_intersect_cuda(tree, o, d, 1e-4, bound,
                                                 any_hit=True)))
        for field in ("t", "prim", "u", "v"):
            for a, b in pairs:
                assert torch.equal(getattr(a, field).view(torch.int32),
                                   getattr(b, field).view(torch.int32)), \
                    (name, field)


def test_hier_walk_probe_needs_the_records(cuda):
    tree = hier.pack_hierarchical(_sphere_soup(cuda))
    o, d, _ = _rays(64, 1, (-1, -1, -1), (1, 1, 1), cuda)
    for records in (tree.child_records[:, :8], tree.child_records.double()):
        with pytest.raises((ValueError, TypeError)):
            mega.hier_trace_probe(tree._replace(child_records=records), o, d,
                                  1e-4, float("inf"))


# -- the megakernel's environment, texture and cutout branches ---------------------

def _extras_scene(name, device):
    from bifrost3d_tpu_torch.apps.scenes import SCENES
    builder = SCENES[name] if name in SCENES else TEST_SCENES[name]
    return builder(device=device)


@pytest.mark.parametrize("name, hier_trace, feature", [
    ("Sphere", False, "environment"),
    ("sphere_sun", False, "environment"),
    ("textured_cornell", False, "texture"),
    ("Opacity", False, "march"),
    ("hier_bridge_15k_env", True, "environment"),
    ("opacity_hier", True, "march"),
    # The viewer's plain RenderSettings: cutouts with any-hit shadow rays.
    ("Opacity", False, "any_hit"),
    ("opacity_hier", True, "any_hit"),
])
def test_extras_megakernel_matches_plain_version(cuda, name, hier_trace,
                                                 feature):
    """Each new branch, kernel against plain version, on both traces."""
    res = 64
    scene, cam = _extras_scene(name, cuda)
    settings = (pt.RenderSettings(max_bounce_count=2) if feature == "any_hit"
                else pt.settings_for_scene(scene, max_bounce_count=2))
    assert mega.megakernel_ineligibility_reasons(scene, settings) == []
    assert pt.explain_render_path(scene, settings).startswith("megakernel")
    args = mega.megakernel_frame_inputs(scene, cam, res, res, 1, settings)
    cfg = args[-1]
    assert cfg.extras and cfg.hier == hier_trace
    assert {"environment": cfg.env_meta is not None and cfg.n_nee_total
            == scene.lights.count + 1,
            "texture": any(mt[0] >= 0 for mt in cfg.mat_tex),
            "march": cfg.shadow_steps == 4 and cfg.any_coverage,
            "any_hit": cfg.shadow_steps == 0 and cfg.any_coverage}[feature]
    _assert_kernel_matches_plain(scene, cam, res, settings, min_mean=1e-4)


@pytest.mark.parametrize("name", ["Sphere", "Opacity", "opacity_hier"])
def test_extras_frame_matches_wavefront(cuda, name):
    """render_sample_fast: one megakernel launch, no trace-kernel launch,
    under the statistical gate against the pooled wavefront."""
    res = 64
    scene, cam = _extras_scene(name, cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    before = mega.launch_count, dense.launch_count, hier.launch_count
    img = pt.render_sample_fast(scene, cam, res, res, 1, settings)
    torch.cuda.synchronize()
    assert (mega.launch_count, dense.launch_count, hier.launch_count) == (
        before[0] + 1, before[1], before[2])
    ref = pt.render_sample_pooled(scene, cam, res, res, 1, settings)
    assert_statistical_gate(img.cpu().numpy(), ref.cpu().numpy())


def test_environment_frame_matches_cpu_wavefront(cuda):
    """The map's conventions (u, v, pdf cell, pool weights) on the card
    against the wavefront on the CPU, whose tests hold it to JAX."""
    res = 48
    scene, cam = TEST_SCENES["sphere_sun"](device=cuda)
    cpu_scene, cpu_cam = TEST_SCENES["sphere_sun"](device="cpu")
    img = pt.render_sample_fast(
        scene, cam, res, res, 2,
        pt.settings_for_scene(scene, max_bounce_count=2))
    ref = pt.render_sample_pooled(
        cpu_scene, cpu_cam, res, res, 2,
        pt.settings_for_scene(cpu_scene, max_bounce_count=2))
    assert_statistical_gate(img.cpu().numpy(), ref.numpy())


def test_untouched_scene_keeps_its_instantiation(cuda):
    """A scene with no map, texture, cutout or march launches without the
    extras: no table is handed over, the flag is off, and forcing the
    extras instantiation on the same inputs gives the same frame."""
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    args = mega.megakernel_frame_inputs(scene, cam, 64, 64, 1, settings)
    assert not args[-1].extras and args[-2] is None
    assert not args[-1].any_coverage and args[-1].shadow_steps == 0
    plain, _ = mega.mesh_megakernel_cuda(*args)
    # Binary shadows through the march (steps = 1: the last step occludes
    # fully) take the extras instantiation and must agree.
    forced = args[-1]._replace(shadow_steps=1)
    assert forced.extras
    marched, _ = mega.mesh_megakernel_cuda(*args[:-1], forced)
    torch.cuda.synchronize()
    assert_statistical_gate(marched.cpu().numpy(), plain.cpu().numpy(),
                            KERNEL_FLIPS, KERNEL_MEAN)


def test_extras_wrapper_validates(cuda):
    scene, cam = _extras_scene("Opacity", cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    args = mega.megakernel_frame_inputs(scene, cam, 16, 16, 0, settings)
    cfg, extras = args[-1], args[-2]
    with pytest.raises(ValueError, match="binds a texture"):
        mega.mesh_megakernel_cuda(*args[:-2], extras._replace(texels=None),
                                  cfg)
    linear = tuple(m[:5] + (1,) for m in cfg.tex_meta)
    with pytest.raises(ValueError, match="NEAREST"):
        mega.mesh_megakernel_cuda(*args[:-1], cfg._replace(tex_meta=linear))
    with pytest.raises(ValueError, match="one entry per material"):
        mega.mesh_megakernel_cuda(*args[:-1],
                                  cfg._replace(mat_tex=cfg.mat_tex[:1]))
    sphere, scam = _extras_scene("sphere_sun", cuda)
    sargs = mega.megakernel_frame_inputs(sphere, scam, 16, 16, 0, settings)
    with pytest.raises(ValueError, match="env_pool"):
        mega.mesh_megakernel_cuda(
            *sargs[:-2], sargs[-2]._replace(env_pool=None), sargs[-1])
    with pytest.raises(ValueError, match="env_img"):
        mega.mesh_megakernel_cuda(
            *sargs[:-2], sargs[-2]._replace(env_img=sargs[-2].env_img[:5]),
            sargs[-1])


# -- gradients: the train step on the card -----------------------------------------

def _cornell_train_step(scene, cam, target, res, settings):
    """mean((render_sample - target)²) and its gradient over materials.tint,
    every launch count at 0 before it → (loss, gradient, B1 launches in the
    forward, in the backward)."""
    from bifrost3d_tpu_torch.diff import image_l2_loss
    dense.reset_launch_count()
    tint = scene.materials.tint.detach().clone().requires_grad_()
    img = pt.render_sample(
        scene._replace(materials=scene.materials._replace(tint=tint)), cam,
        res, res, 1, settings)
    loss = image_l2_loss(img, target)
    forward = dense.launch_count
    (grad,) = torch.autograd.grad(loss, tint)
    torch.cuda.synchronize()
    return float(loss.detach()), grad, forward, dense.launch_count - forward


@pytest.fixture(scope="module")
def cornell_train():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    scene, cam = create_cornell_box(device=torch.device("cuda"))
    settings = pt.settings_for_scene(scene, max_bounce_count=2,
                                     remat_bounces=False)
    with torch.no_grad():
        target = pt.render_sample(scene, cam, 64, 64, 0, settings)
    return scene, cam, target, settings


def test_train_step_on_card_replay_and_remat_match_plain(cuda, cornell_train):
    """The Cornell train step at 64², 2 bounces on the card: plain, replay
    and remat give the same loss bit for bit and gradients within rtol
    1e-5, atol 1e-8; two B1 launches an iteration in each forward, none in
    a plain or replay backward, the forward's again in remat's."""
    scene, cam, target, plain = cornell_train
    iters = 2 + 1 + plain.passthrough_slack
    v1, g1, f1, b1 = _cornell_train_step(scene, cam, target, 64, plain)
    assert (f1, b1) == (2 * iters, 0)
    assert float(g1.abs().max()) > 0.0 and bool(torch.isfinite(g1).all())
    for settings, backward in ((plain._replace(detached_replay_vjp=True), 0),
                               (plain._replace(remat_bounces=True),
                                2 * iters)):
        v2, g2, f2, b2 = _cornell_train_step(scene, cam, target, 64, settings)
        assert (f2, b2) == (2 * iters, backward)
        assert v2 == v1
        torch.testing.assert_close(g2, g1, rtol=1e-5, atol=1e-8)


def test_kernel_trace_gradient_matches_plain_trace(cuda, cornell_train,
                                                   monkeypatch):
    """The same plain step with the trace on its plain version: hits differ
    only at ties, so the gradient is within 1e-3 of its largest component
    and the loss within rtol 1e-4."""
    scene, cam, target, plain = cornell_train
    v1, g1, launches, _ = _cornell_train_step(scene, cam, target, 64, plain)
    assert launches > 0
    monkeypatch.setattr(dense, "pallas_intersect",
                        dense.dense_intersect_reference)
    v2, g2, launches, _ = _cornell_train_step(scene, cam, target, 64, plain)
    assert launches == 0
    assert abs(v2 - v1) <= 1e-4 * v1
    assert float((g2 - g1).abs().max()) <= 1e-3 * float(g1.abs().max())


def test_offset_ray_origin_gradient_on_card(cuda):
    """On CUDA tensors: the forward bit for bit the CPU's, the position's
    gradient passed through on both branches, the normal's zero."""
    from bifrost3d_tpu_torch.math.ray_offset import offset_ray_origin
    rng = np.random.default_rng(11)
    p = np.concatenate([rng.uniform(-3, 3, (500, 3)),
                        rng.uniform(-0.03, 0.03, (500, 3))]).astype(np.float32)
    n = rng.normal(size=(1000, 3)).astype(np.float32)
    cot = rng.normal(size=(1000, 3)).astype(np.float32)
    position = torch.tensor(p, device=cuda, requires_grad=True)
    normal = torch.tensor(n, device=cuda, requires_grad=True)
    out = offset_ray_origin(position, normal)
    assert torch.equal(out.detach().cpu(),
                       offset_ray_origin(torch.tensor(p), torch.tensor(n)))
    gp, gn = torch.autograd.grad(out, (position, normal),
                                 torch.tensor(cot, device=cuda),
                                 allow_unused=True, materialize_grads=True)
    assert torch.equal(gp.cpu(), torch.tensor(cot))
    assert not bool(gn.any())


# -- scenes loaded from files ----------------------------------------------------------

@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """A 2,256-triangle sphere on a plane as OBJ + MTL (untextured, for the
    megakernel's BVH branch) and a 4,608-triangle torus with PNG textures as
    GLB (the pooled wavefront), both written with numpy only."""
    from bifrost3d_tpu_torch.geometry.creation import make_torus
    from bifrost3d_tpu_torch.geometry.mesh import combine_meshes
    from torch_scene_files import write_obj, write_textured_glb
    d = tmp_path_factory.mktemp("scene_files")
    parts = [make_sphere(radius=0.5, slices=48, stacks=24),
             make_plane(size=3.0)]
    mesh = combine_meshes(parts)
    idx = mesh.indices
    write_obj(str(d / "ball.obj"), mesh.positions[idx],
              np.repeat([0, 1], [p.indices.shape[0] for p in parts]),
              [dict(name="ball", Kd=(0.8, 0.3, 0.2), Ns=60, illum=2, d=1.0),
               dict(name="floor", Kd=(0.6, 0.6, 0.6), Ns=2, illum=2)],
              tri_normals=mesh.normals[idx], tri_uvs=mesh.texcoords[idx])
    rng = np.random.default_rng(4)
    write_textured_glb(str(d / "torus.glb"),
                       make_torus(major_segments=96, minor_segments=24),
                       rng.integers(0, 256, (64, 64, 4)),
                       rng.integers(0, 256, (64, 64, 3)))
    return {"obj": str(d / "ball.obj"), "glb": str(d / "torus.glb")}


def test_loaded_obj_renders_through_hier_megakernel(cuda, scene_files):
    """The OBJ's scene on the card: the megakernel's BVH branch (B3), one
    launch a frame and no trace-kernel launch, against its plain version
    on the same lanes."""
    from bifrost3d_tpu_torch.apps.simple_viewer import build_scene_from_file
    scene, cam = build_scene_from_file(scene_files["obj"], None,
                                       (0.68, 0.92, 1.0), device=cuda)
    assert scene.tri_verts.shape[0] > mega.MAX_TRIS
    settings = pt.RenderSettings(max_bounce_count=2)
    assert pt.explain_render_path(scene, settings) == \
        "megakernel (hier: cluster-BVH DMA trace)"
    before = mega.launch_count, dense.launch_count, hier.launch_count
    pt.render_sample_fast(scene, cam, 64, 64, 1, settings)
    torch.cuda.synchronize()
    assert (mega.launch_count, dense.launch_count, hier.launch_count) == (
        before[0] + 1, before[1], before[2])
    _assert_kernel_matches_plain(scene, cam, 64, settings)


def test_loaded_glb_renders_through_bvh_kernel(cuda, scene_files, monkeypatch):
    """The textured GLB (bilinear and metallic textures: the pooled
    wavefront), forced onto the BVH trace (B4): the kernel launched, the
    dense one not, the frame against the same frame on the plain trace; its
    AOVs too, one B4 launch."""
    from unittest import mock
    from bifrost3d_tpu_torch.apps.simple_viewer import build_scene_from_file
    from bifrost3d_tpu_torch.integrator.aov import render_aovs
    monkeypatch.setattr(traverse, "PALLAS_MAX_TRIS", 100)
    scene, cam = build_scene_from_file(scene_files["glb"], None,
                                       (0.68, 0.92, 1.0), device=cuda)
    assert scene.textures.count == 3 and scene.tri_clustered is not None
    settings = pt.RenderSettings(max_bounce_count=2)
    assert pt.explain_render_path(scene, settings).startswith(
        "wavefront [BVH trace")
    before, dense_before = hier.launch_count, dense.launch_count
    img = pt.render_sample_fast(scene, cam, 64, 64, 1, settings)
    torch.cuda.synchronize()
    assert hier.launch_count > before and dense.launch_count == dense_before
    with mock.patch.object(hier, "hierarchical_intersect",
                           hier.hierarchical_intersect_reference):
        ref = pt.render_sample_fast(scene, cam, 64, 64, 1, settings)
    assert_statistical_gate(img.cpu().numpy(), ref.cpu().numpy())
    assert float(img.mean()) > 0.01
    before = hier.launch_count
    aovs = render_aovs(scene, cam, 64, 64)
    torch.cuda.synchronize()
    assert hier.launch_count == before + 1
    with mock.patch.object(hier, "hierarchical_intersect",
                           hier.hierarchical_intersect_reference):
        plain = render_aovs(scene, cam, 64, 64)
    same = (aovs["primitive_id"] == plain["primitive_id"]).all(-1)
    assert float(same.float().mean()) >= 0.999
    for name in ("tint", "roughness"):
        assert torch.equal(aovs[name][same], plain[name][same]), name


# -- the viewer's modes ------------------------------------------------------------------

def test_path_regularization_on_card_matches_cpu(cuda):
    """Path regularization takes the pooled wavefront on the dense trace
    (B1), never the megakernel; the card's 64² frame against the CPU's,
    with and without decay."""
    scene, cam = create_cornell_box(device=cuda)
    cpu_scene, cpu_cam = create_cornell_box(device="cpu")
    for decay in (0.0, 0.5):
        settings = pt.RenderSettings(max_bounce_count=2,
                                     path_regularization_scale=1.0,
                                     path_regularization_decay=decay)
        assert "path regularization" in pt.explain_render_path(scene, settings)
        before = mega.launch_count, dense.launch_count
        img = pt.render_sample_fast(scene, cam, 64, 64, 3, settings)
        torch.cuda.synchronize()
        assert mega.launch_count == before[0]
        assert dense.launch_count > before[1]
        ref = pt.render_sample_fast(cpu_scene, cpu_cam, 64, 64, 3, settings)
        assert_statistical_gate(img.cpu().numpy(), ref.numpy())


def _distant_floor(device):
    """tests/test_textures.py's distant checkered floor with the port's
    API: a 200-unit plane, a directional light, a 256² trilinear
    checker."""
    from bifrost3d_tpu_torch.io.texture import FILTER_TRILINEAR, TextureBank
    from bifrost3d_tpu_torch.lights.types import LIGHT_DIRECTIONAL, LightArray
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    from bifrost3d_tpu_torch.scene.materials import MaterialArray
    from bifrost3d_tpu_torch.scene.render_scene import build_render_scene
    c = np.indices((256, 256)).sum(axis=0) % 2
    bank = TextureBank.build([dict(image=np.stack([c, c, c], -1).astype(
        np.float32), filter=FILTER_TRILINEAR)], device=device)
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


def test_trilinear_floor_on_card_matches_cpu(cuda):
    scene, cam = _distant_floor(cuda)
    cpu_scene, cpu_cam = _distant_floor("cpu")
    settings = pt.settings_for_scene(scene, max_bounce_count=0,
                                     next_event_sample_count=1)
    assert settings.trilinear_textures
    before = dense.launch_count
    img = pt.render_sample_fast(scene, cam, 64, 64, 0, settings)
    torch.cuda.synchronize()
    assert dense.launch_count > before
    ref = pt.render_sample_fast(cpu_scene, cpu_cam, 64, 64, 0, settings)
    assert_statistical_gate(img.cpu().numpy(), ref.numpy())
    level0 = pt.render_sample_fast(scene, cam, 64, 64, 0, settings._replace(
        trilinear_textures=False)).cpu().numpy()
    img = img.cpu().numpy()
    horizon = next(i for i in range(64) if level0[i].mean() > 1e-4)
    rows = slice(horizon + 1, horizon + 7)
    assert level0[rows].mean(-1).std(1).mean() > \
        2.0 * img[rows].mean(-1).std(1).mean()


def test_denoised_backend_on_card(cuda):
    """Three frames: three megakernel launches and one AOV trace (B1); the
    running mean against the CPU's, the denoised image equal to the CPU's
    filter on the card's own inputs."""
    from bifrost3d_tpu_torch.integrator.backend import (
        DenoisedBackend, atrous_denoise)
    scene, cam = create_cornell_box(device=cuda)
    cpu_scene, cpu_cam = create_cornell_box(device="cpu")
    settings = pt.RenderSettings(max_bounce_count=2)
    backend = DenoisedBackend(scene, cam, 64, 64, settings)
    cpu = DenoisedBackend(cpu_scene, cpu_cam, 64, 64, settings)
    before = mega.launch_count, dense.launch_count
    means = []
    for _ in range(3):
        img = backend.render()
        means.append(backend.buffer.cpu())
        cpu.render()
    torch.cuda.synchronize()
    assert (mega.launch_count - before[0], dense.launch_count - before[1]) \
        == (3, 1)
    assert_statistical_gate(backend.buffer.cpu().numpy(), cpu.buffer.numpy())
    # Frame 3 presents frame 2's image, denoised from frame 2's mean.
    ref = atrous_denoise(means[1], backend._aovs["shading_normal"].cpu(),
                         backend._aovs["albedo"].cpu())
    torch.testing.assert_close(img.cpu(), ref, rtol=1e-5, atol=1e-5)


def test_preview_on_card_matches_cpu(cuda):
    """A layer's primary trace and each light's shadow trace launch the
    dense trace kernel: 1 + 1 × lights a CornellBox frame, 4 + 4 × lights
    an Opacity frame; each frame against the CPU's."""
    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.preview import render_preview
    for name, layers in (("CornellBox", 1), ("Opacity", 4)):
        scene, cam = SCENES[name](device=cuda)
        cpu_scene, cpu_cam = SCENES[name](device="cpu")
        before = dense.launch_count
        img = render_preview(scene, cam, 64, 64)
        torch.cuda.synchronize()
        assert dense.launch_count - before == layers * (
            1 + scene.lights.count), name
        ref = render_preview(cpu_scene, cpu_cam, 64, 64)
        # chip_smoke.py's budgets: the trace kernel and its plain version
        # part at triangle edges, and SSAO spreads those pixels.
        assert_statistical_gate(img.cpu().numpy(), ref.numpy(), 0.05, 0.005)
        img = render_preview(scene, cam, 64, 64, enable_ssao=False)
        ref = render_preview(cpu_scene, cpu_cam, 64, 64, enable_ssao=False)
        assert_statistical_gate(img.cpu().numpy(), ref.numpy(), 0.01, 0.005)


def test_checkpoint_resume_on_card_is_bit_equal(cuda, tmp_path, capsys):
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.io.image import load_exr
    base = ["--window-size", "64x64", "--checkpoint-every", "2"]
    ckpt = str(tmp_path / "ckpt")
    simple_viewer.main(base + ["-n", "2", "--checkpoint-dir", ckpt, "-o",
                               str(tmp_path / "a.exr")])
    simple_viewer.main(base + ["-n", "4", "--checkpoint-dir", ckpt, "-o",
                               str(tmp_path / "b.exr")])
    assert "resumed at accumulation 2" in capsys.readouterr().out
    simple_viewer.main(base + ["-n", "4", "-o", str(tmp_path / "c.exr")])
    b, c = load_exr(str(tmp_path / "b.exr")), load_exr(str(tmp_path / "c.exr"))
    assert np.array_equal(b.view(np.uint32), c.view(np.uint32))


# -- The engine: SceneSync, the compositor and the live viewer ---------------------

def _engine_compositor(device, scene="Sphere", size=64, bounces=2):
    """The viewer's datamodel scene behind a compositor on ``device`` with
    its path tracer, ticked once by an engine (the scene's first build)."""
    from bifrost3d_tpu_torch.apps.interactive_viewer import build_scene
    from bifrost3d_tpu_torch.core import Engine
    from bifrost3d_tpu_torch.core.compositor import Compositor
    from bifrost3d_tpu_torch.integrator.backend import SimpleBackend
    data, cam = build_scene(scene)
    comp = Compositor(data, size, size, device=device)
    data.cameras.set_renderer(cam, comp.add_renderer(
        "PathTracer", lambda s, c, w, h: SimpleBackend(
            s, c, w, h, pt.RenderSettings(max_bounce_count=bounces))))
    engine = Engine()
    comp.attach(engine)
    engine.do_tick(1.0 / 60)
    torch.cuda.synchronize()
    return data, cam, comp, engine


def test_compositor_tick_on_sphere_is_one_hier_megakernel_launch(cuda):
    """The viewer's Sphere (2,210 triangles) ticks through B3: one
    megakernel launch a tick, no trace kernel; the HDR screenshot against
    the CPU compositor's under the statistical gate."""
    data, cam, comp, engine = _engine_compositor(cuda)
    scene = comp.sync.handle_updates()
    assert scene.tri_verts.shape[0] == 2210
    assert pt.explain_render_path(scene, pt.RenderSettings(
        max_bounce_count=2)) == "megakernel (hier: cluster-BVH DMA trace)"
    before = mega.launch_count, dense.launch_count, hier.launch_count
    for _ in range(3):
        engine.do_tick(1.0 / 60)
    torch.cuda.synchronize()
    assert (mega.launch_count - before[0], dense.launch_count - before[1],
            hier.launch_count - before[2]) == (3, 0, 0)
    cpu_data, cpu_cam, cpu_comp, cpu_engine = _engine_compositor(
        torch.device("cpu"))
    for _ in range(3):
        cpu_engine.do_tick(1.0 / 60)
    for d, c in ((data, cam), (cpu_data, cpu_cam)):
        d.cameras.request_screenshot(c, content="hdr")
    engine.do_tick(1.0 / 60)
    cpu_engine.do_tick(1.0 / 60)
    (shot,) = data.cameras.resolve_screenshot(cam)
    (ref,) = cpu_data.cameras.resolve_screenshot(cpu_cam)
    assert shot["iterations"] == ref["iterations"] == 5
    assert_statistical_gate(shot["image"].cpu().numpy(),
                            ref["image"].numpy())


def test_tint_edit_repacks_no_geometry(cuda):
    """A material edit replaces the material table only: the megakernel's
    geometry pack cache hits, its frame-table cache misses once."""
    data, cam, comp, engine = _engine_compositor(cuda)
    packs, frames = mega._PACK_CACHE.stores, mega._FRAME_CACHE.stores
    engine.do_tick(1.0 / 60)
    assert (mega._PACK_CACHE.stores, mega._FRAME_CACHE.stores) == (
        packs, frames)
    scene = comp.sync.handle_updates()
    red = [m for m in data.materials if data.materials.get_params(m)[
        "tint"] == (0.8, 0.2, 0.15)][0]
    data.materials.set_tint(red, (0.2, 0.8, 0.15))
    before = mega.launch_count
    engine.do_tick(1.0 / 60)
    torch.cuda.synchronize()
    edited = comp.sync.handle_updates()
    assert edited.tri_verts is scene.tri_verts and edited.bvh is scene.bvh
    assert edited.materials is not scene.materials
    assert mega._PACK_CACHE.stores == packs
    assert mega._FRAME_CACHE.stores == frames + 1
    assert mega.launch_count - before == 1
    backend = next(iter(comp._backends.values()))
    assert backend.accumulations == 1


def test_camera_move_keeps_the_device_scene(cuda):
    """A 'w' through the viewer's navigation moves the camera's host
    transform: the device scene is the same object, the camera's
    accumulation restarts."""
    from bifrost3d_tpu_torch.apps.interactive_viewer import CameraNavigation
    from bifrost3d_tpu_torch.core import Keyboard
    data, cam, comp, engine = _engine_compositor(cuda)
    engine.do_tick(1.0 / 60)
    scene = comp.sync.handle_updates()
    kb = Keyboard()
    kb.press("w")
    kb.release("w")
    CameraNavigation(data, cam).handle(kb, 1.0 / 30)
    assert data.cameras.get_transform(cam).translation.device.type == "cpu"
    engine.do_tick(1.0 / 60)
    assert comp.sync.handle_updates() is scene
    assert next(iter(comp._backends.values())).accumulations == 1


def test_interactive_viewer_runs_on_card(cuda, tmp_path, capsys):
    from bifrost3d_tpu_torch.apps.interactive_viewer import run
    shot = tmp_path / "shot.png"
    frames, data, comp = run("Sphere", 64, 48, ticks=6, scripted_keys="wwpx",
                             display=False, screenshot_path=str(shot),
                             max_bounce=2, device=cuda)
    frame = next(iter(frames.values()))
    assert frame.device.type == "cuda" and frame.shape == (48, 64, 3)
    assert bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.01
    assert shot.exists()
    cam = next(iter(data.cameras))
    assert comp.renderers.get_name(data.cameras.get_renderer(cam)) == "Preview"
    # Without a terminal the run prints nothing, as JAX's does.
    assert capsys.readouterr().out == ""


# -- the last modules: parallel/, host_build, the fittings -------------------

def test_sharded_render_on_card_equals_unsharded(cuda):
    """Two shards on one card render the frame the unsharded pooled
    wavefront renders, bit for bit, and launch the dense trace (B1)."""
    from bifrost3d_tpu_torch.parallel import make_sharded_render
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=2)
    full, _ = pt.render_pixels_pooled(scene, cam, 64, 61, 1, settings)
    dense.reset_launch_count()
    got = make_sharded_render([cuda] * 2, 64, 61, settings)(scene, cam, 1)
    torch.cuda.synchronize()
    assert dense.launch_count > 0
    assert torch.equal(got, full.reshape(61, 64, 3))


def test_sharded_train_step_on_card(cuda):
    """Two shards' summed gradient equals one shard's within the all-reduce
    tolerances, and a step moves the tint."""
    from bifrost3d_tpu_torch.parallel import make_sharded_train_step
    scene, cam = create_cornell_box(device=cuda)
    settings = pt.settings_for_scene(scene, max_bounce_count=1)
    with torch.no_grad():
        target = pt.render_sample(scene, cam, 32, 32, 0, settings)
    start = scene._replace(materials=scene.materials._replace(
        tint=torch.clamp(scene.materials.tint * 0.6 + 0.15, 0.0, 1.0)))
    runs = []
    for shards in (1, 2):
        init_fn, step_fn = make_sharded_train_step([cuda] * shards, 32, 32,
                                                   settings)
        params, state = init_fn(start)
        new, state, loss = step_fn(params, state, start, cam, target, 1)
        runs.append((float(loss), state.mu["tint"] / 0.1, new["tint"]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=2e-4, atol=2e-6)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=2e-4, atol=2e-6)
    assert not torch.equal(runs[1][2], start.materials.tint)


def test_host_build_lands_on_card(cuda):
    from bifrost3d_tpu_torch.utils.hostbuild import host_build
    scene, cam = host_build(create_cornell_box)(device="cpu")
    assert scene.tri_verts.device.type == "cuda"
    assert cam.projection.device.type == "cuda"
    ref, _ = create_cornell_box(device="cpu")
    assert torch.equal(scene.tri_verts.cpu(), ref.tri_verts)


def test_precompute_fittings_on_card_matches_cpu(cuda):
    from bifrost3d_tpu_torch.shading.fittings import precompute_fittings
    card = precompute_fittings(256, None, device=cuda)
    cpu = precompute_fittings(256, None, device="cpu")
    for name in card._fields:
        got, want = getattr(card, name), getattr(cpu, name)
        assert got.device.type == "cuda"
        diff = (got.cpu() - want).abs()
        # tests/test_torch_fittings_precompute.py's gates.
        if name.startswith("dielectric"):
            assert diff.max() <= 1e-2 and diff.mean() <= 1e-4, name
        else:
            assert diff.max() <= 1e-5, name


def test_ltc_fit_row_graph_equals_eager(cuda):
    """The Nelder-Mead iteration captured as a CUDA graph and replayed
    gives the eager loop's bits."""
    from bifrost3d_tpu_torch.shading import ltc_fit
    cos = torch.clamp_min(torch.arange(64, device=cuda) / 63.0,
                          ltc_fit._MIN_FIT_COS)
    u2 = ltc_fit._stratified_u2(16, cuda)
    x0 = torch.zeros((64, 4), device=cuda)
    runs = [ltc_fit.fit_row(cos, ltc_fit._row_alpha(40, 64), x0, u2, 12,
                            graph=graph) for graph in (True, False)]
    for got, want in zip(*runs):
        assert torch.equal(got, want)
