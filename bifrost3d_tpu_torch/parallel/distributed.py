"""Multi-process distribution on ``torch.distributed``: process wiring, the
global mesh, host-local rows.

Port of ``bifrost3d_tpu/parallel/distributed.py``. N processes (one per
card, or several on one card) join one process group; the global mesh is
the concatenation, in rank order, of every process's local devices along
``'tiles'``. Pixel rows shard over the global mesh, the scene replicates,
and every process renders only its own rows (a :class:`GlobalRows`).
Reductions ride ``all_reduce`` and readback ``all_gather``.

- Backend: ``nccl`` when every rank has a card of its own on this host,
  ``gloo`` otherwise (NCCL refuses two ranks on one card, so several ranks
  on one card, or on the CPU, take gloo). gloo reduces CUDA tensors in
  place but gathers only CPU tensors, so :func:`gather_rows` stages a
  gloo gather of CUDA rows through the host.
- ``python -m bifrost3d_tpu_torch.parallel.distributed`` runs
  :func:`run_selftest`: two processes on this host render over one global
  mesh and check their result against one process's render.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from bifrost3d_tpu_torch.parallel.mesh import pad_to_multiple, render_mesh
from bifrost3d_tpu_torch.parallel.render import pooled_shard, smallpt_shard

# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Join (or form) the process group. Idempotent.

    Each field comes from its argument, else from JAX's environment
    variables ``BIFROST_COORDINATOR`` (``host:port``) /
    ``BIFROST_NUM_PROCESSES`` / ``BIFROST_PROCESS_ID``, else from
    torch's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
    With a card, the process renders on ``cuda:local_device_ids[0]``, by
    default ``cuda:(rank mod the card count)``. A single process may skip
    calling this.
    """
    if is_initialized():
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("BIFROST_COORDINATOR"))
    if num_processes is None:
        num_processes = int(os.environ.get(
            "BIFROST_NUM_PROCESSES", os.environ.get("WORLD_SIZE", 1)))
    if process_id is None:
        process_id = int(os.environ.get(
            "BIFROST_PROCESS_ID", os.environ.get("RANK", 0)))
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    backend = "gloo"
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        index = (local_device_ids[0] if local_device_ids is not None
                 else process_id % cards)
        torch.cuda.set_device(index)
        if local_device_ids is None and num_processes <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_devices() -> list:
    """This process's default device: its current card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]


class GlobalMesh(NamedTuple):
    """The 1-D ``'tiles'`` mesh over every process's devices: this
    process's own devices hold global shards ``process_index ·
    len(local)`` onwards (every process has as many)."""

    local: list
    process_index: int
    process_count: int

    @property
    def size(self) -> int:
        return self.process_count * len(self.local)


def global_render_mesh(devices=None) -> GlobalMesh:
    """The global mesh with ``devices`` (default :func:`local_devices`) as
    this process's part, keeping each process's devices contiguous."""
    local = render_mesh(local_devices() if devices is None else devices)
    return GlobalMesh(local, process_index(), process_count())


def _as_global(mesh) -> GlobalMesh:
    """A single-process mesh (a list of devices) as a GlobalMesh."""
    if isinstance(mesh, GlobalMesh):
        return mesh
    return GlobalMesh(list(mesh), 0, 1)


# ---------------------------------------------------------------------------
# Host-local <-> global rows
# ---------------------------------------------------------------------------

class GlobalRows(NamedTuple):
    """A row-sharded buffer of ``global_rows`` rows as one process holds it:
    its own row blocks, one per local device, starting at global row
    ``start``."""

    blocks: list
    start: int
    global_rows: int


def shard_rows_local(mesh, global_rows: int) -> tuple[int, int]:
    """This process's [start, stop) row slice of a row-sharded buffer;
    ``global_rows`` must already be padded to a multiple of the global
    device count (``pad_to_multiple``)."""
    mesh = _as_global(mesh)
    if global_rows % mesh.size:
        raise ValueError(f"{global_rows} rows do not divide over a mesh of "
                         f"{mesh.size} devices")
    local = len(mesh.local) * (global_rows // mesh.size)
    return mesh.process_index * local, (mesh.process_index + 1) * local


def make_global_rows(mesh, local_np: np.ndarray, global_rows: int
                     ) -> GlobalRows:
    """A row-sharded buffer from this process's rows (numpy): one block per
    local device, on that device."""
    mesh = _as_global(mesh)
    lo, hi = shard_rows_local(mesh, global_rows)
    if local_np.shape[0] != hi - lo:
        raise ValueError(f"this process holds rows [{lo}, {hi}), got "
                         f"{local_np.shape[0]}")
    rows = torch.as_tensor(np.ascontiguousarray(local_np))
    blocks = [b.to(d) for b, d in zip(rows.chunk(len(mesh.local)),
                                      mesh.local)]
    return GlobalRows(blocks, lo, global_rows)


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Σ of ``tensor`` over the processes (itself in a single process)."""
    if process_count() > 1:
        tensor = tensor.clone()
        dist.all_reduce(tensor)
    return tensor


def gather_rows(global_array: GlobalRows) -> np.ndarray:
    """All-gather a row-sharded buffer to a host numpy array on every
    process: for final readback only, the render loop never calls it."""
    local = torch.cat([b.to(global_array.blocks[0].device)
                       for b in global_array.blocks])
    if process_count() == 1:
        return local.cpu().numpy()
    if dist.get_backend() == "gloo":
        local = local.cpu()            # gloo gathers CPU tensors only
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat([p.cpu() for p in parts]).numpy()


# ---------------------------------------------------------------------------
# Multi-process renders
# ---------------------------------------------------------------------------

def make_multihost_smallpt(mesh, width: int, height: int):
    """SmallPT over a (possibly multi-process) global mesh:
    render(scene, accumulation) -> GlobalRows of the padded frame (row 0 =
    bottom). Use :func:`gather_rows` and crop for readback."""
    mesh = _as_global(mesh)
    padded_h = pad_to_multiple(height, mesh.size)
    rows = padded_h // mesh.size
    first = shard_rows_local(mesh, padded_h)[0]

    def render(scene, accumulation):
        blocks = [smallpt_shard(scene, width, height, accumulation,
                                first + j * rows, rows, d)
                  for j, d in enumerate(mesh.local)]
        return GlobalRows(blocks, first, padded_h)

    return render


def make_multihost_render(mesh, width: int, height: int, settings=None):
    """The mesh-scene pooled wavefront over a global mesh:
    render(scene, camera, accumulation) -> GlobalRows of the padded frame;
    the same layout as ``make_sharded_render``, from 1 process × 1 device
    to N processes × M devices."""
    from bifrost3d_tpu_torch.integrator.path_tracer import RenderSettings
    settings = settings or RenderSettings()
    mesh = _as_global(mesh)
    padded_h = pad_to_multiple(height, mesh.size)
    rows = padded_h // mesh.size
    first_shard = mesh.process_index * len(mesh.local)

    def render(scene, camera, accumulation):
        blocks = [pooled_shard(scene, camera, width, height, accumulation,
                               settings, 65536, first_shard + j, rows, d)
                  for j, d in enumerate(mesh.local)]
        return GlobalRows(blocks, first_shard * rows, padded_h)

    return render


# ---------------------------------------------------------------------------
# Same-host multi-process self-test
# ---------------------------------------------------------------------------

SELFTEST_SIZE = (32, 24)          # SmallPT width, height
SELFTEST_MESH_SIZE = 16           # CornellBox width = height


def _selftest_worker(coordinator: str, num_processes: int, process_id: int,
                     devices_per_process: int, device: str) -> None:
    """One process of the self-test: the processes form a group, render
    SmallPT and CornellBox over the global mesh, all-reduce a checksum and
    a sharded gradient, and process 0 holds the gathered frames and the
    gradient against a single-process render."""
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.integrator.path_tracer import (
        render_pixels_pooled, settings_for_scene)
    from bifrost3d_tpu_torch.integrator.smallpt import (
        render_smallpt_accumulation, render_smallpt_pixels)
    from bifrost3d_tpu_torch.parallel.render import pixel_rows
    from bifrost3d_tpu_torch.utils.tree import tree_to
    from bifrost3d_tpu_torch.scene.spheres import smallpt_scene

    torch.set_num_threads(1)
    initialize(coordinator, num_processes, process_id)
    try:
        if process_count() != num_processes:
            raise RuntimeError(f"{process_count()} processes joined, "
                               f"expected {num_processes}")
        if device == "cuda":
            devices = local_devices() * devices_per_process
        else:
            devices = [torch.device(device)] * devices_per_process
        mesh = global_render_mesh(devices)
        width, height = SELFTEST_SIZE
        scene = smallpt_scene(device=devices[0])
        img = make_multihost_smallpt(mesh, width, height)(scene, 1)
        full = gather_rows(img)[:height]

        # A cross-process collective: the sum of every process's rows.
        local_sum = sum(b.sum() for b in img.blocks)
        total = float(all_reduce_sum(local_sum))
        np.testing.assert_allclose(total, full.sum(), rtol=1e-5)

        # The sharded train-step gradient: every process differentiates its
        # rows, and the all-reduce over all processes' shards must give the
        # single-process gradient.
        padded_h = pad_to_multiple(height, mesh.size)
        rows = padded_h // mesh.size
        denom = float(width * height * 3)
        grad = torch.zeros_like(scene.color)
        for j, d in enumerate(mesh.local):
            color = scene.color.detach().to(d).requires_grad_()
            x, y = pixel_rows(img.start + j * rows, rows, width, d)
            im = render_smallpt_pixels(
                tree_to(scene, d)._replace(color=color), x, y, width,
                height, 1)
            loss = torch.sum(torch.where((y < height)[..., None],
                                         torch.square(im), 0.0))
            grad = grad + torch.autograd.grad(loss, color)[0].to(grad.device)
        g_global = (all_reduce_sum(grad) / denom).cpu().numpy()
        if not np.all(np.isfinite(g_global)):
            raise RuntimeError("the all-reduced gradient is not finite")

        # The mesh wavefront over the global mesh.
        cornell, cam = create_cornell_box(device=devices[0])
        settings = settings_for_scene(cornell, max_bounce_count=2)
        side = SELFTEST_MESH_SIZE
        frame = gather_rows(make_multihost_render(mesh, side, side, settings)(
            cornell, cam, 1))[:side]

        if process_id == 0:
            single = render_smallpt_accumulation(scene, width, height, 1)
            np.testing.assert_allclose(full, single.cpu().numpy(), rtol=1e-5,
                                       atol=1e-5)
            color = scene.color.detach().clone().requires_grad_()
            im = render_smallpt_accumulation(scene._replace(color=color),
                                             width, height, 1)
            g_ref = torch.autograd.grad(torch.mean(torch.square(im)),
                                        color)[0]
            np.testing.assert_allclose(g_global, g_ref.cpu().numpy(),
                                       atol=1e-5, rtol=2e-3)
            ref, _ = render_pixels_pooled(cornell, cam, side, side, 1,
                                          settings)
            np.testing.assert_allclose(
                frame, ref.reshape(side, side, 3).cpu().numpy(), rtol=1e-5,
                atol=1e-5)
            print(f"DISTRIBUTED_SELFTEST_OK backend={dist.get_backend()} "
                  f"processes={num_processes} mesh={mesh.size} "
                  f"device={devices[0]}", flush=True)
    finally:
        shutdown()


_WORKER = ("import sys; from bifrost3d_tpu_torch.parallel.distributed "
           "import _main; sys.exit(_main(sys.argv))")


def run_selftest(num_processes: int = 2, devices_per_process: int = 2,
                 timeout: float = 300.0, device: str = "cpu") -> str:
    """Spawn a same-host multi-process render on ``device`` ("cpu" or
    "cuda") and verify it → process 0's report line. Every process has
    its own time limit: a hung rank is killed and the self-test fails."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "BIFROST_COORDINATOR", "BIFROST_NUM_PROCESSES",
                        "BIFROST_PROCESS_ID")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, "--worker", coordinator,
             str(num_processes), str(i), str(devices_per_process), device],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(num_processes)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\n[killed after {timeout} s]"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"distributed selftest worker {i} failed "
                f"(rc={p.returncode}):\n{out[-4000:]}")
    ok = [line for line in outs[0].splitlines()
          if line.startswith("DISTRIBUTED_SELFTEST_OK")]
    if not ok:
        raise RuntimeError(
            f"worker 0 did not report success:\n{outs[0][-4000:]}")
    return ok[0]


def _main(argv):
    if len(argv) >= 7 and argv[1] == "--worker":
        _selftest_worker(argv[2], int(argv[3]), int(argv[4]), int(argv[5]),
                         argv[6])
        return 0
    device = argv[1] if len(argv) > 1 else (
        "cuda" if torch.cuda.is_available() else "cpu")
    print(run_selftest(device=device))
    print("selftest passed")
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(_main(sys.argv))
