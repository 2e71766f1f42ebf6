"""The camera-effects chain on the card as two CUDA kernels.

``csrc/post_chain.cu`` computes what :func:`post.pipeline._process_plain`
computes for an image on a CUDA card: :func:`exposure_cuda` one pass for
the luminance histogram or log-average (nothing in the fixed mode) whose
last block resolves the exposure and eye adaptation into a 0-d tensor,
and :func:`apply_cuda` one pass for exposure × vignette, the tonemapper,
film grain and the clamp. Every setting goes in as a kernel argument
packed here (:func:`exposure_params`, :func:`apply_params`), so a call
copies nothing from the host and waits for nothing: at most a memset and
two launches on the current stream. The plain version is the eager chain
in ``post/pipeline.py``, which a CPU image takes. A failed build or launch
raises; nothing falls back. ``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bifrost3d_tpu_torch.post import tonemap as tm
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

_THREADS = 256          # csrc/post_chain.cu's kThreads, sizing the grid
_PIXELS_PER_THREAD = 4
_BLOCKS_PER_SM = 4      # the exposure pass's grid, per SM
_WORKSPACE_HEAD = 33    # doubles before the partials: 64 bins + the counter

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class ExposureParams(ctypes.Structure):
    """``struct ExposureParams`` of ``csrc/post_chain.cu``."""
    _fields_ = [
        ("previous_ptr", ctypes.c_void_p), ("delta_time_ptr", ctypes.c_void_p),
        ("mode", ctypes.c_int), ("n_pixels", ctypes.c_int),
        ("aligned", ctypes.c_int), ("adapt", ctypes.c_int),
        ("min_log", ctypes.c_float), ("log_range", ctypes.c_float),
        ("inv_log_range", ctypes.c_float),
        ("min_percentage", ctypes.c_float), ("max_percentage", ctypes.c_float),
        ("bias", ctypes.c_float), ("bias_scale", ctypes.c_float),
        ("previous", ctypes.c_float), ("delta_time", ctypes.c_float),
        ("brightness", ctypes.c_float), ("darkness", ctypes.c_float),
    ]


_FLOAT9 = ctypes.c_float * 9


class ApplyParams(ctypes.Structure):
    """``struct ApplyParams`` of ``csrc/post_chain.cu``."""
    _fields_ = [
        ("exposure_ptr", ctypes.c_void_p), ("exposure", ctypes.c_float),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("n_pixels", ctypes.c_int), ("aligned", ctypes.c_int),
        ("vignette_on", ctypes.c_int), ("vignette", ctypes.c_float),
        ("inv_width", ctypes.c_float), ("inv_height", ctypes.c_float),
        ("tonemap", ctypes.c_int),
        ("m_in", _FLOAT9), ("m_out", _FLOAT9), ("rgb2y", ctypes.c_float * 3),
        ("toe_match", ctypes.c_float), ("straight_match", ctypes.c_float),
        ("shoulder_match", ctypes.c_float), ("slope", ctypes.c_float),
        ("toe_rate", ctypes.c_float), ("toe_numerator", ctypes.c_float),
        ("neg_black_clip", ctypes.c_float),
        ("shoulder_rate", ctypes.c_float),
        ("shoulder_numerator", ctypes.c_float),
        ("white_one", ctypes.c_float), ("inv_denom", ctypes.c_float),
        ("flip", ctypes.c_int),
        ("min_ev", ctypes.c_float), ("inv_ev_range", ctypes.c_float),
        ("start_compression", ctypes.c_float),
        ("compression_d", ctypes.c_float), ("compression_dd", ctypes.c_float),
        ("desaturation", ctypes.c_float),
        ("grain_on", ctypes.c_int), ("grain_scale", ctypes.c_float),
        ("grain_x", ctypes.c_uint32), ("grain_y", ctypes.c_uint32),
    ]


def _reciprocal(x: float) -> float:
    """float32 ``1 / float32(x)``: how PyTorch's eager CUDA kernels divide
    a tensor by a Python number."""
    return float(np.float32(1.0) / np.float32(x))


def _scalar(value):
    """(device pointer or None, host value) of a number or 0-d tensor; a
    CUDA tensor is read on the card, a CPU one here (no device wait)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        return value.to(torch.float32).reshape(()), 0.0
    return None, float(value)


def exposure_params(settings: CameraEffectsSettings, n_pixels: int,
                    previous_exposure, delta_time) -> tuple:
    """→ (ExposureParams, tensors whose pointers it holds)."""
    if settings.exposure_mode not in (EXPOSURE_FIXED, EXPOSURE_LOG_AVERAGE,
                                      EXPOSURE_HISTOGRAM):
        raise ValueError(f"unknown exposure mode {settings.exposure_mode}")
    previous, previous_value = _scalar(previous_exposure)
    dt, dt_value = _scalar(delta_time)
    lo, hi = settings.min_log_luminance, settings.max_log_luminance
    p = ExposureParams(
        previous_ptr=None if previous is None else previous.data_ptr(),
        delta_time_ptr=None if dt is None else dt.data_ptr(),
        mode=settings.exposure_mode, n_pixels=n_pixels,
        adapt=int(bool(settings.eye_adaptation_enabled)),
        min_log=lo, log_range=hi - lo, inv_log_range=_reciprocal(hi - lo),
        min_percentage=settings.min_histogram_percentage,
        max_percentage=settings.max_histogram_percentage,
        bias=settings.log_luminance_bias,
        bias_scale=2.0 ** settings.log_luminance_bias,
        previous=previous_value, delta_time=dt_value,
        brightness=settings.eye_adaptation_brightness,
        darkness=settings.eye_adaptation_darkness)
    return p, (previous, dt)


def _rows(m) -> _FLOAT9:
    return _FLOAT9(*np.asarray(m, np.float32).reshape(9).tolist())


def apply_params(settings: CameraEffectsSettings, width: int, height: int,
                 frame_index: int) -> ApplyParams:
    """The apply kernel's settings: vignette, the tonemapper's constants
    (computed in float64, passed as float32) and the grain's hash offsets.
    Its exposure fields are set by the caller."""
    mode = settings.tonemapping_mode
    if mode not in (TONEMAP_LINEAR, TONEMAP_FILMIC, TONEMAP_AGX,
                    TONEMAP_KHRONOS_NEUTRAL):
        raise ValueError(f"unknown tonemapping mode {mode}")
    p = ApplyParams(width=width, height=height, n_pixels=width * height,
                    vignette_on=int(settings.vignette > 0.0),
                    vignette=settings.vignette,
                    inv_width=_reciprocal(width),
                    inv_height=_reciprocal(height), tonemap=mode)
    if mode == TONEMAP_FILMIC:
        t = settings.tonemapping
        (toe_scale, shoulder_scale, toe_match, straight_match,
         shoulder_match) = tm.filmic_curve(t)
        denom = shoulder_match - toe_match
        if abs(denom) < 1e-10:
            denom = 1e-10
        p.m_in, p.m_out = _rows(tm._SRGB_TO_AP1), _rows(tm._AP1_TO_SRGB)
        p.rgb2y = (ctypes.c_float * 3)(
            *np.asarray(tm._AP1_RGB2Y, np.float32).tolist())
        p.toe_match, p.straight_match = toe_match, straight_match
        p.shoulder_match, p.slope = shoulder_match, t.slope
        p.toe_rate = -2.0 * t.slope / toe_scale
        p.toe_numerator = 2.0 * toe_scale
        p.neg_black_clip = -t.black_clip
        p.shoulder_rate = 2.0 * t.slope / shoulder_scale
        p.shoulder_numerator = 2.0 * shoulder_scale
        p.white_one = 1.0 + t.white_clip
        p.inv_denom = _reciprocal(denom)
        p.flip = int(shoulder_match < toe_match)
    elif mode == TONEMAP_AGX:
        min_ev, max_ev = -12.47393, 4.026069
        p.m_in, p.m_out = _rows(tm._LINEAR_TO_AGX), _rows(tm._AGX_TO_TONEMAPPED)
        p.min_ev, p.inv_ev_range = min_ev, _reciprocal(max_ev - min_ev)
    elif mode == TONEMAP_KHRONOS_NEUTRAL:
        start_compression = 0.8 - 0.04
        d = 1.0 - start_compression
        p.start_compression, p.compression_d = start_compression, d
        p.compression_dd, p.desaturation = d * d, 0.15
    if settings.film_grain > 0.0:
        p.grain_on, p.grain_scale = 1, 2.0 * settings.film_grain
        p.grain_x = frame_index & 0xFFFFFFFF
        p.grain_y = (frame_index * 31) & 0xFFFFFFFF
    return p


@functools.lru_cache(maxsize=64)
def _packed_apply_params(settings: CameraEffectsSettings, width: int,
                         height: int, frame_index: int) -> bytes:
    """:func:`apply_params` packed once per settings, size and grain frame
    (a copy is made per call: packing costs more host time than the
    launch)."""
    return bytes(apply_params(settings, width, height, frame_index))


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("post_chain.cu")
    lib.post_exposure.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ExposureParams), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.post_exposure.restype = ctypes.c_int
    lib.post_apply.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.POINTER(ApplyParams), ctypes.c_void_p]
    lib.post_apply.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _checked_image(image):
    if image.device.type != "cuda":
        raise ValueError(f"the post chain's kernels need an image on a CUDA "
                         f"card, not {image.device}")
    if image.dim() != 3 or image.shape[-1] != 3:
        raise ValueError(f"the post chain takes an [h, w, 3] image, not "
                         f"{tuple(image.shape)}")
    h, w = int(image.shape[0]), int(image.shape[1])
    if h <= 0 or w <= 0 or 3 * h * w >= 2**31:
        raise ValueError(f"{w}x{h} pixels outside the kernels' int32 "
                         "indexing")
    return image.to(torch.float32).contiguous()


def _aligned(*tensors) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def exposure_cuda(image, settings: CameraEffectsSettings, previous_exposure,
                  delta_time):
    """The applied exposure of ``image`` [h, w, 3] on the card, eye
    adaptation included (``previous_exposure`` a number or a 0-d tensor,
    < 0 to snap) → 0-d float32 tensor. One memset and one launch (one
    launch of one block in the fixed mode)."""
    global launch_count
    image = _checked_image(image)
    n = image.shape[0] * image.shape[1]
    # ``held`` keeps the tensors behind p's pointers alive past the launch.
    p, held = exposure_params(settings, n, previous_exposure, delta_time)
    p.aligned = _aligned(image)
    groups = -(-n // _PIXELS_PER_THREAD)
    blocks = max(1, min(-(-groups // _THREADS),
                        _BLOCKS_PER_SM * _sm_count(image.device.index or 0)))
    workspace = torch.empty(_WORKSPACE_HEAD + blocks, dtype=torch.float64,
                            device=image.device)
    exposure = torch.empty((), dtype=torch.float32, device=image.device)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = _library().post_exposure(image.data_ptr(), ctypes.byref(p),
                                   workspace.data_ptr(), exposure.data_ptr(),
                                   blocks, stream)
    _check(err, "post_exposure")
    launch_count += 1
    return exposure


def apply_cuda(image, exposure, settings: CameraEffectsSettings,
               frame_index: int):
    """``image`` [h, w, 3] × ``exposure`` (a 0-d CUDA tensor or a number)
    → vignette → tonemap → grain → clamp to [0, 1], a new [h, w, 3]
    float32 tensor. One launch."""
    global launch_count
    image = _checked_image(image)
    h, w = int(image.shape[0]), int(image.shape[1])
    grain_frame = frame_index if settings.film_grain > 0.0 else 0
    p = ApplyParams.from_buffer_copy(_packed_apply_params(settings, w, h,
                                                          grain_frame))
    if isinstance(exposure, torch.Tensor):
        exposure = exposure.to(device=image.device,
                               dtype=torch.float32).reshape(())
        p.exposure_ptr = exposure.data_ptr()
    else:
        p.exposure = float(exposure)
    ldr = torch.empty_like(image)
    p.aligned = _aligned(image, ldr)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = _library().post_apply(image.data_ptr(), ldr.data_ptr(),
                                ctypes.byref(p), stream)
    _check(err, "post_apply")
    launch_count += 1
    return ldr

