"""Preview renderer: the rasterizer-style fast path.

Port of ``bifrost3d_tpu/preview`` (``renderer``, ``ibl``, ``ssao``), the
counterpart of the reference's DX11Renderer: primary visibility through
the scene's trace (on a card the scene's trace kernel, as the path
tracer's), then a G-buffer → SSAO → direct light with hard shadow rays +
ambient or environment → camera effects, one frame per call with no
progressive accumulation (the viewer's ``--renderer preview``).
"""

from bifrost3d_tpu_torch.preview.ibl import convolve_environment, sample_ibl
from bifrost3d_tpu_torch.preview.ssao import ssao
from bifrost3d_tpu_torch.preview.renderer import render_preview
