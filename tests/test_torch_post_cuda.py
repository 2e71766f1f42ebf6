"""The post chain's two CUDA kernels (post/post_chain.py,
csrc/post_chain.cu) against the eager chain, on the card.

The eager chain (``pipeline._process_plain``) runs on the same HDR image on
the card, so the comparison is of arithmetic, not of the CPU's libm. Every
exposure mode x every tonemapper, vignette and grain on and off, both
blooms, and the stateful path with a number, a device tensor and a
negative previous exposure, at 512 x 512 and at a ragged 37 x 53 (its last
group of four pixels short, its rows not a multiple of four). Limits: LDR
max abs 1e-5, exposure relative 1e-5 (the sums over the image are taken in
double by the kernel and in float32 by the eager chain). Also: no host
synchronisation (torch's sync debug mode raises on one), at most three
operations on the card a call, the launch counter, determinism.

    python -m pytest --noconftest -m cuda tests/test_torch_post_cuda.py -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bifrost3d_tpu_torch.post import pipeline, post_chain
from bifrost3d_tpu_torch.post.tonemap import (
    EXPOSURE_FIXED,
    EXPOSURE_HISTOGRAM,
    EXPOSURE_LOG_AVERAGE,
    TONEMAP_AGX,
    TONEMAP_FILMIC,
    TONEMAP_KHRONOS_NEUTRAL,
    TONEMAP_LINEAR,
    CameraEffectsSettings,
)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(512, 512), (37, 53)]
SIZE_IDS = ["512x512", "37x53"]
LDR_LIMIT = 1e-5
EXPOSURE_LIMIT = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _hdr(h, w, device, seed=3):
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(-1.0, 1.5, size=(h, w, 3))).astype(np.float32)
    img[0, 0] = 0.0
    img[h // 2, w // 3] = 40.0      # a highlight for bloom
    return torch.tensor(img, device=device)


def _settings(**kw):
    return CameraEffectsSettings.preset()._replace(**kw)


def _compare(image, settings, frame_index=5, previous=-1.0, dt=1 / 60):
    """The kernels against the eager chain on the same image → theirs."""
    ldr, exposure = pipeline._process(image, settings, frame_index,
                                      previous, dt)
    ref, ref_exposure = pipeline._process_plain(image, settings, frame_index,
                                                previous, dt)
    assert ldr.shape == ref.shape and ldr.dtype == torch.float32
    assert ldr.is_cuda and exposure.is_cuda and exposure.dim() == 0
    gap = float((ldr - ref).abs().max())
    rel = abs(float(exposure) / float(ref_exposure) - 1.0)
    assert gap <= LDR_LIMIT and rel <= EXPOSURE_LIMIT, (gap, rel)
    return ldr, exposure


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("tonemap", [TONEMAP_LINEAR, TONEMAP_FILMIC,
                                     TONEMAP_AGX, TONEMAP_KHRONOS_NEUTRAL])
@pytest.mark.parametrize("exposure_mode", [EXPOSURE_FIXED,
                                           EXPOSURE_LOG_AVERAGE,
                                           EXPOSURE_HISTOGRAM])
def test_every_exposure_and_tonemap_mode(cuda, exposure_mode, tonemap, size):
    image = _hdr(*size, cuda)
    _compare(image, _settings(exposure_mode=exposure_mode,
                              tonemapping_mode=tonemap,
                              log_luminance_bias=0.25))


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("vignette,grain", [(0.0, 0.0), (0.63, 0.0),
                                            (0.0, 1 / 255), (0.63, 1 / 255)])
def test_vignette_and_grain(cuda, vignette, grain, size):
    _compare(_hdr(*size, cuda), _settings(vignette=vignette,
                                          film_grain=grain), frame_index=77)


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("bloom_mode", [0, 1], ids=["gaussian",
                                                    "dual_kawase"])
def test_bloom_between_the_kernels(cuda, bloom_mode, size):
    before = post_chain.launch_count
    _compare(_hdr(*size, cuda), _settings(bloom_mode=bloom_mode,
                                          bloom_threshold=1.0,
                                          bloom_support=0.05))
    assert post_chain.launch_count == before + 2


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("previous", ["float", "tensor", "negative_float",
                                      "negative_tensor"])
def test_process_stateful_previous_exposure(cuda, previous, size):
    value = -1.0 if previous.startswith("negative") else 0.8
    prev = torch.tensor(value, device=cuda) if previous.endswith("tensor") \
        else value
    for mode in (EXPOSURE_HISTOGRAM, EXPOSURE_LOG_AVERAGE, EXPOSURE_FIXED):
        _compare(_hdr(*size, cuda), _settings(exposure_mode=mode),
                 previous=prev, dt=0.1)


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_three_frames_feed_back_the_exposure(cuda, size):
    """process_stateful over three frames, the returned 0-d tensor handed
    back each time, against the eager chain handed its own."""
    settings = _settings()
    prev, ref_prev = -1.0, -1.0
    for frame in range(3):
        image = _hdr(*size, cuda, seed=frame) * (1.0 + 2.0 * frame)
        ldr, prev = pipeline.process_stateful(image, settings, frame, prev,
                                              1 / 30)
        ref, ref_prev = pipeline._process_plain(image, settings, frame,
                                                ref_prev, 1 / 30)
        assert float((ldr - ref).abs().max()) <= LDR_LIMIT
        assert abs(float(prev) / float(ref_prev) - 1.0) <= EXPOSURE_LIMIT


def test_process_makes_no_host_sync(cuda):
    image = _hdr(512, 512, cuda)
    settings = _settings(film_grain=0.0)
    pipeline.process(image, settings)
    prev = torch.tensor(0.5, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ldr = pipeline.process(image, settings)
        ldr2, exposure = pipeline.process_stateful(image, _settings(), 1,
                                                   prev, 1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(ldr.max()) <= 1.0 and float(ldr2.mean()) > 0.0
    assert float(exposure) > 0.0


# Run in a process of its own: torch.profiler on the card has lost the
# card's trace in a later session of one process, so a session here would
# take the first one from the profiling tests of test_torch_cuda.py.
_COUNT_OPERATIONS = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from bifrost3d_tpu_torch.post import pipeline, post_chain
from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
image = torch.rand(512, 512, 3, device="cuda")
modes = [CameraEffectsSettings.preset()._replace(exposure_mode=m)
         for m in (%d, %d, %d)]
for settings in modes:
    pipeline.process(image, settings)
torch.cuda.synchronize()
before = post_chain.launch_count
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for settings in modes:
        torch.cuda._sleep(1000)
        pipeline.process(image, settings)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
card = sorted((e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA),
              key=lambda e: e.time_range.start)
names = [e.name for e in card]
spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
print(json.dumps({"ops": [names[a + 1:b] for a, b in zip(spins, spins[1:])],
                  "launches": post_chain.launch_count - before}))
""" % (EXPOSURE_FIXED, EXPOSURE_LOG_AVERAGE, EXPOSURE_HISTOGRAM)


def test_at_most_three_operations_a_call(cuda):
    """With bloom off one call puts a memset (not in the fixed mode) and two
    kernels on the card, and launch_count counts the kernels: one profiler
    session over a call in each exposure mode, split at spin kernels on the
    card's clock."""
    proc = subprocess.run([sys.executable, "-c", _COUNT_OPERATIONS],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    fixed, log_average, histogram = got["ops"]
    assert len(fixed) == 2 and not any("Memset" in n for n in fixed), fixed
    for ops in (log_average, histogram):
        assert len(ops) == 3 and sum("Memset" in n for n in ops) == 1, ops
    assert all(sum(k in n for n in ops) == 1 for ops in got["ops"]
               for k in ("exposure_kernel", "apply_kernel"))
    assert got["launches"] == 6


@pytest.mark.parametrize("exposure_mode", [EXPOSURE_LOG_AVERAGE,
                                           EXPOSURE_HISTOGRAM])
def test_exposure_is_deterministic(cuda, exposure_mode):
    image = _hdr(512, 512, cuda, seed=9)
    settings = _settings(exposure_mode=exposure_mode)
    first = [pipeline._process(image, settings, 0, -1.0, 0.0)
             for _ in range(3)]
    for ldr, exposure in first[1:]:
        assert torch.equal(exposure, first[0][1])
        assert torch.equal(ldr, first[0][0])


def test_misaligned_and_strided_images(cuda):
    """A view 4 bytes off 16-byte alignment takes the kernels' scalar loads;
    a non-contiguous image is made contiguous first."""
    base = _hdr(64, 65, cuda).reshape(-1)
    image = base[1:1 + 63 * 65 * 3].reshape(63, 65, 3)
    assert image.data_ptr() % 16 != 0
    _compare(image, _settings())
    _compare(_hdr(64, 80, cuda).transpose(0, 1), _settings())
