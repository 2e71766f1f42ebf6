"""The port's spans and counters (utils/profiling.py ``span``,
``counters``), on the CPU.

Without a ``torch.profiler`` session a span is one shared no-op context.
Under one, a progressive render of CornellBox (8 x 8, 2 accumulations,
the dispatch sent to the megakernel's plain version as on a card it would
take the kernel) and its post chain leave ``b3d.`` host spans nested as
the layers are: one ``render.progressive`` holding one ``render.frame``
per accumulation, and ``post.process`` holding each stage that runs;
the SmallPT app's render (16 x 12, 2 accumulations) one
``smallpt.progressive`` holding one ``smallpt.frame`` per accumulation.
``counters`` reads the launch, cache and build counters of the loaded
modules and the megakernel's accumulated frames, which a progressive
render on the CPU leaves as they were; a material table replaced by
``_replace`` rebuilds the frame's tables once. The product dispatch
launches no sum of the ray tally it drops. The kernel's argument struct
and its ctypes mirror name the same fields in the same order.
"""

import os
import re
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bifrost3d_tpu_torch.apps import smallpt_app
from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.post.pipeline import process
from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
from bifrost3d_tpu_torch.utils import cuda_build, profiling
import torch_parity  # noqa: F401  (one torch thread per worker)

RES = 8
ACCUMULATIONS = 2
STAGES = ("exposure", "bloom", "vignette", "tonemap", "grain")


@pytest.fixture(scope="module")
def cornell():
    scene, camera = create_cornell_box(device="cpu")
    return scene, camera, tpt.settings_for_scene(scene, max_bounce_count=2)


@pytest.fixture
def on_the_megakernel(monkeypatch):
    monkeypatch.setattr(tpt, "_device_kind", lambda scene: "cuda")


def _spans(prof) -> list:
    """The session's ``b3d.`` events → [(name, start_ns, end_ns)] by
    start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(profiling.SPAN_PREFIX)),
                  key=lambda e: e[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_session_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("render.frame") is profiling._NO_SPAN
    assert profiling.span("post.process") is profiling._NO_SPAN
    with profiling.span("render.frame") as entered:
        assert entered is None


def test_span_under_a_session_records_a_prefixed_host_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = profiling.span("render.frame")
        assert ctx is not profiling._NO_SPAN
        with ctx:
            torch.ones(4).sum()
    assert [name for name, _, _ in _spans(prof)] == ["b3d.render.frame"]
    assert profiling.span("render.frame") is profiling._NO_SPAN


@pytest.mark.parametrize("high_precision", [False, True])
def test_render_and_post_spans_nest_as_the_layers(cornell, on_the_megakernel,
                                                  high_precision):
    scene, camera, settings = cornell
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hdr = tpt.render_progressive(scene, camera, RES, RES, ACCUMULATIONS,
                                     settings, high_precision=high_precision)
        ldr = process(hdr, CameraEffectsSettings.preset())
    assert ldr.shape == (RES, RES, 3)
    spans = _spans(prof)
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    progressive = by_name["b3d.render.progressive"]
    frames = by_name["b3d.render.frame"]
    post = by_name["b3d.post.process"]
    assert len(progressive) == 1 and len(post) == 1
    assert len(frames) == ACCUMULATIONS
    assert all(_inside(f, progressive[0]) for f in frames)
    assert frames[0][2] <= frames[1][1]
    assert progressive[0][2] <= post[0][1]
    stages = [s for s in spans if s[0].startswith("b3d.post.")
              and s[0] != "b3d.post.process"]
    assert [s[0] for s in stages] == [f"b3d.post.{n}" for n in STAGES]
    assert all(_inside(s, post[0]) for s in stages)
    # The megakernel's launch span is the card's: the plain version has none.
    assert set(by_name) == {"b3d.render.progressive", "b3d.render.frame",
                            "b3d.post.process",
                            *(f"b3d.post.{n}" for n in STAGES)}


def test_smallpt_spans_nest_as_the_layers():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = smallpt_app.render_progressive(16, 12, ACCUMULATIONS,
                                                quiet=True, device="cpu")
    spans = _spans(prof)
    progressive = [s for s in spans if s[0] == "b3d.smallpt.progressive"]
    frames = [s for s in spans if s[0] == "b3d.smallpt.frame"]
    assert len(progressive) == 1 and len(frames) == ACCUMULATIONS
    assert all(_inside(f, progressive[0]) for f in frames)
    assert frames[0][2] <= frames[1][1]
    # The kernel's launch span is the card's: the plain version has none.
    assert {s[0] for s in spans} == {"b3d.smallpt.progressive",
                                     "b3d.smallpt.frame"}
    plain = smallpt_app.render_progressive(16, 12, ACCUMULATIONS, quiet=True,
                                           device="cpu")
    assert torch.equal(traced.view(torch.int32), plain.view(torch.int32))


def test_smallpt_spans_record_nothing_without_a_session(monkeypatch):
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def record(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", record)
    img = smallpt_app.render_progressive(16, 12, ACCUMULATIONS, quiet=True,
                                         device="cpu")
    assert img.shape == (12, 16, 3) and made == []
    with profile(activities=[ProfilerActivity.CPU]):
        smallpt_app.render_progressive(16, 12, 1, quiet=True, device="cpu")
    assert made == ["b3d.smallpt.progressive", "b3d.smallpt.frame"]


def test_post_spans_only_for_the_stages_that_run():
    settings = CameraEffectsSettings.preset()._replace(vignette=0.0,
                                                       film_grain=0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        process(torch.rand(RES, RES, 3), settings)
    assert [s[0] for s in _spans(prof)] == [
        "b3d.post.process", "b3d.post.exposure", "b3d.post.bloom",
        "b3d.post.tonemap"]


def test_counters_name_the_launches_and_the_cache_stores(cornell,
                                                         on_the_megakernel):
    scene, camera, settings = cornell
    tpt.render_sample_fast(scene, camera, RES, RES, 0, settings)
    loaded = set(sys.modules)
    got = profiling.counters()
    assert set(sys.modules) == loaded
    assert all(isinstance(v, int) for v in got.values())
    for name in ("integrator.pallas_mesh.launches",
                 "geometry.pallas_intersect.launches",
                 "integrator.pallas_mesh._ELIGIBLE_CACHE.stores",
                 "integrator.pallas_mesh._FRAME_CACHE.stores",
                 "integrator.pallas_mesh._PACK_CACHE.stores",
                 "integrator.path_tracer._DETACHED.stores",
                 "utils.cuda_build.builds", "utils.cuda_build.loads"):
        assert name in got, name
    assert got["integrator.pallas_mesh._FRAME_CACHE.stores"] >= 1
    assert got["integrator.pallas_mesh._FRAME_CACHE.stores"] == \
        tpm._FRAME_CACHE.stores


@pytest.mark.parametrize("dispatch", ["wavefront", "megakernel"])
def test_progressive_render_on_the_cpu_lerps_in_torch(cornell, monkeypatch,
                                                      dispatch):
    """``counters`` names the frames the megakernel lerped into a running
    mean; a progressive render on the CPU, through the pooled wavefront or
    the megakernel's plain version, lerps none there and returns the eager
    loop's running mean bit for bit."""
    scene, camera, settings = cornell
    if dispatch == "megakernel":
        monkeypatch.setattr(tpt, "_device_kind", lambda scene: "cuda")
    name = "integrator.pallas_mesh.accumulated_frames"
    before = profiling.counters()
    assert before[name] == tpm.accumulate_count
    img = tpt.render_progressive(scene, camera, RES, RES, ACCUMULATIONS,
                                 settings)
    assert profiling.counters()[name] == before[name]
    eager = torch.zeros((RES, RES, 3))
    for n in range(ACCUMULATIONS):
        frame = tpt.render_sample_fast(scene, camera, RES, RES, n, settings)
        eager = eager + (frame - eager) / (n + 1)
    assert torch.equal(img.view(torch.int32), eager.view(torch.int32))


def test_kernel_params_mirror_the_cuda_struct():
    """``pallas_mesh._Params`` names ``MegakernelParams``' fields in the
    kernel source's order (the card checks only their total size)."""
    source = os.path.join(os.path.dirname(tpm.__file__), os.pardir, "csrc",
                          "mesh_megakernel.cu")
    with open(source) as f:
        text = f.read()
    body = text[text.index("struct MegakernelParams {"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    # Each declarator's name is the last word before its array size.
    names = [re.findall(r"\w+", part)[-1]
             for decl in re.sub(r"\[[^]]*\]", "", body).split(";")
             if decl.strip() for part in decl.split(",")]
    assert [field[0] for field in tpm._Params._fields_] == names


def test_replaced_material_table_rebuilds_the_frame_tables_once(cornell):
    scene, _, settings = cornell
    tpm._frame_tables(scene, settings)
    before = profiling.counters()
    tpm._frame_tables(scene, settings)
    assert profiling.counters() == before
    edited = scene._replace(materials=scene.materials._replace(
        roughness=scene.materials.roughness * 0.5))
    tpm._frame_tables(edited, settings)
    after = profiling.counters()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"integrator.pallas_mesh._FRAME_CACHE.stores": 1}
    tpm._frame_tables(edited, settings)
    assert profiling.counters() == after


def test_cuda_build_counts_nvcc_runs_and_loads(tmp_path, monkeypatch):
    lib = tmp_path / "libfake.so"
    monkeypatch.setattr(cuda_build, "library_path", lambda source: str(lib))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def nvcc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"so")
        return Done()

    monkeypatch.setattr(cuda_build.subprocess, "run", nvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("lib", path))
    builds, loads = cuda_build.builds, cuda_build.loads
    assert cuda_build.build("fake.cu") == str(lib)
    assert cuda_build.build("fake.cu") == str(lib)
    assert cuda_build.builds == builds + 1
    try:
        assert cuda_build.load("fake_counted.cu") == ("lib", str(lib))
        cuda_build.load("fake_counted.cu")
        assert (cuda_build.builds, cuda_build.loads) == (builds + 1,
                                                          loads + 1)
        got = profiling.counters()
        assert (got["utils.cuda_build.builds"],
                got["utils.cuda_build.loads"]) == (builds + 1, loads + 1)
    finally:
        cuda_build.load.cache_clear()


def test_megakernel_lane_tally_sums_to_the_ray_count(cornell):
    scene, camera, settings = cornell
    img, rays = tpm.render_mesh_megakernel(scene, camera, RES, RES, 1,
                                           settings)
    lane_img, lanes = tpm.render_mesh_megakernel(scene, camera, RES, RES, 1,
                                                 settings, sum_rays=False)
    assert rays.shape == () and lanes.shape == (RES * RES,)
    assert torch.equal(img, lane_img)
    assert float(lanes.sum()) == float(rays)


def test_product_dispatch_launches_no_ray_sum(cornell, on_the_megakernel,
                                              monkeypatch):
    scene, camera, settings = cornell
    seen = []
    real = tpm.render_mesh_megakernel

    def frame(*args, **kw):
        seen.append(kw.get("sum_rays", True))
        return real(*args, **kw)

    monkeypatch.setattr(tpm, "render_mesh_megakernel", frame)
    img = tpt.render_sample_fast(scene, camera, RES, RES, 0, settings)
    assert img.shape == (RES, RES, 3)
    assert seen == [False]
