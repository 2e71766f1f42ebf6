"""Core: engine loop, UID handles, change tracking, input.

Port of ``bifrost3d_tpu/core/`` (``uid``, ``bitmask``, ``changeset``,
``engine``, ``input``, ``compositor``), the counterpart of the reference's
L0 (``core/Bifrost/Bifrost/Core``, SURVEY.md §2.1): the datamodel is the
single source of truth, every manager records per-tick change bitmasks,
renderers diff-sync in ``handle_updates()`` and a tick-cleanup callback
clears notifications. The first five modules are copies of the JAX
package's, which import no JAX.

The device mirror is the port's
:class:`~bifrost3d_tpu_torch.scene.render_scene.RenderScene` on the
compositor's device; ``scene.datamodel.SceneSync`` rebuilds only the
tensors whose managers report changes and resets the progressive
accumulation, the reference's ``handle_updates`` → ``accumulations = 0``
flow (Renderer.cpp:1202-1204).
"""

from bifrost3d_tpu_torch.core.uid import TypedUIDGenerator, UID
from bifrost3d_tpu_torch.core.bitmask import Bitmask
from bifrost3d_tpu_torch.core.changeset import ChangeSet
from bifrost3d_tpu_torch.core.engine import Engine, Time, Window
from bifrost3d_tpu_torch.core.input import Keyboard, Mouse
