"""BVH ray trace for scenes too large for the dense kernel.

Port of ``bifrost3d_tpu/geometry/pallas_bvh.py`` (``HierTriangles``,
``pack_hierarchical``, ``hierarchical_intersect``,
``hierarchical_intersect_sorted``). The TPU kernel ``_make_hier_kernel``
becomes the hand-written CUDA kernel ``csrc/bvh_intersect.cu`` (one thread
per ray with a private stack, one 64-byte child record per step
(:func:`pack_child_records`), persistent warps taking 32-ray batches; it
reads the rays and bounds as given and writes the final hits, so a call is
one memset and one launch; its header says what bounds it on an H100).

:func:`hierarchical_intersect` dispatches on the device of the rays: CUDA
tensors launch the kernel, CPU tensors take the plain PyTorch version
:func:`hierarchical_intersect_reference` — the lockstep traversal of
``geometry/traverse.py`` over the same packed tree — anything else raises.
A failed build or launch raises; nothing falls back. ``launch_count``
counts kernel launches (plain-version calls do not count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np

import torch

from bifrost3d_tpu_torch.geometry.bvh import (
    BVH,
    STACK_SIZE,
    build_soup_bvh,
)
from bifrost3d_tpu_torch.geometry.pallas_intersect import (
    _check,
    kernel_bound,
    kernel_live,
)
from bifrost3d_tpu_torch.geometry.traverse import (
    Hit,
    ray_bounds,
    traverse_lockstep,
)
from bifrost3d_tpu_torch.math.morton import morton_encode_3d

_THREADS = 128      # the kernel's block size, one ray per thread

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class HierTriangles(NamedTuple):
    """The packed triangle BVH, all on one device.

    The JAX package packs a two-level tree for its TPU kernel: 512-triangle
    clusters under a BVH of cluster boxes, because that kernel walks the
    tree once per ray block and tests a cluster densely. The CUDA kernel
    walks per ray, so this packing is the triangle BVH itself
    (``geometry/bvh.py``: leaves of at most 4 triangles) in records sized
    for 16-byte loads. ``order`` and ``n_tris`` keep the JAX meaning: slot
    → original triangle id, and the number of slots that may hold a
    triangle. ``node_boxes`` is the plain version's table; the kernels
    walk ``child_records``, the same tree as one 64-byte record per
    internal node (:func:`pack_child_records`).
    """

    tri_components: torch.Tensor  # [T, 12] f32 leaf-ordered (v0, e1, e2, 0 0 0)
    node_boxes: torch.Tensor      # [n, 8] f32: lo.xyz, hi.xyz, then node_a
                                  #   and node_count as int32 bits
    order: torch.Tensor           # [T] int32 → original triangle ids
    n_tris: int
    max_depth: int                # of the tree; the kernel's stack holds
                                  #   STACK_SIZE entries
    child_records: torch.Tensor   # [1 + internal nodes, 16] f32

    @property
    def node_meta(self) -> torch.Tensor:
        """[n, 2] int32 (node_a, node_count): leaf → (first slot, count),
        internal → (right child, 0); the left child is node + 1."""
        return self.node_boxes[:, 6:8].contiguous().view(torch.int32)


def pack_hierarchical(tri_verts, bvh: BVH | None = None) -> HierTriangles:
    """[t, 3, 3] world-space triangles → the packed BVH, on the device of
    ``tri_verts`` (a numpy array packs on the CPU).

    ``bvh`` is the tree over these triangles (built here, on the host, when
    not given); its depth is checked against the traversal stack.
    """
    tv = torch.as_tensor(tri_verts, dtype=torch.float32)
    device = tv.device
    t = int(tv.shape[0])
    if bvh is None:
        bvh = build_soup_bvh(tv)
    bvh = bvh.to(device)
    if bvh.prim_indices.shape[0] != t:
        raise ValueError(f"the BVH orders {bvh.prim_indices.shape[0]} "
                         f"triangles, the soup has {t}")
    depth = bvh.max_depth
    if depth + 1 > STACK_SIZE:
        raise ValueError(f"BVH depth {depth} exceeds the kernel "
                         f"stack ({STACK_SIZE})")
    order = bvh.prim_indices.to(torch.int32)
    sorted_tv = tv[order.long()]
    v0 = sorted_tv[:, 0]
    comp = torch.zeros((t, 12), dtype=torch.float32, device=device)
    comp[:, 0:3] = v0
    comp[:, 3:6] = sorted_tv[:, 1] - v0
    comp[:, 6:9] = sorted_tv[:, 2] - v0
    meta = torch.stack([bvh.node_a, bvh.node_count], dim=1).to(torch.int32)
    boxes = torch.cat([bvh.node_min.to(torch.float32),
                       bvh.node_max.to(torch.float32),
                       meta.contiguous().view(torch.float32)], dim=1)
    packed = HierTriangles(tri_components=comp.contiguous(),
                           node_boxes=boxes.contiguous(),
                           order=order.contiguous(), n_tris=t,
                           max_depth=depth, child_records=None)
    return packed._replace(child_records=pack_child_records(packed))


# A leaf reference of a child record: ~(first slot << 3 | count - 1).
LEAF_COUNT_BITS = 3
MAX_LEAF_SLOT = 2**(31 - LEAF_COUNT_BITS) - 1


def pack_child_records(packed: HierTriangles) -> torch.Tensor:
    """The tree of ``packed.node_boxes`` as child records → float32
    [1 + internal nodes, 16] on the tree's device, for the kernels' walk
    (``csrc/bvh_walk.cuh``): one step reads one 64-byte row and slab-tests
    both children from it, where the node table needs the node's own
    record before its children's boxes.

    Row 0 holds the root: its box (lo.xyz, hi.xyz in columns 0-5) and its
    reference (column 12). Rows 1.. are the internal nodes in the node
    table's depth-first order, so an internal left child's row follows its
    parent's (a descent reads neighbouring rows, two to a 128-byte line):
    the left child's box (0-5), the right child's box (6-11), the left and
    the right reference (12, 13, int32 bits), zeros (14, 15). A reference r > 0 is
    internal row r; r < 0 a leaf ``~(first slot << 3 | count - 1)``; row 0
    is never a child, so 0 means none. The leaves' triangle slots are the
    packing's own."""
    boxes = packed.node_boxes[:, 0:6].detach().cpu().numpy()
    meta = packed.node_meta.cpu().numpy()
    a, count = meta[:, 0].astype(np.int64), meta[:, 1].astype(np.int64)
    leaf = count > 0
    if leaf.any() and (count.max() > 1 << LEAF_COUNT_BITS
                       or a[leaf].max() > MAX_LEAF_SLOT):
        raise ValueError(f"a leaf holds more than {1 << LEAF_COUNT_BITS} "
                         f"triangles or starts past slot {MAX_LEAF_SLOT}")
    internal = np.flatnonzero(~leaf)
    row = np.zeros(len(a), np.int64)
    row[internal] = np.arange(1, len(internal) + 1)
    ref = np.where(leaf, ~((a << LEAF_COUNT_BITS) | (count - 1)), row)
    table = np.zeros((1 + len(internal), 16), np.float32)
    bits = table.view(np.int32)
    table[0, 0:6] = boxes[0]
    bits[0, 12] = ref[0]
    left, right = internal + 1, a[internal]
    table[1:, 0:6] = boxes[left]
    table[1:, 6:12] = boxes[right]
    bits[1:, 12] = ref[left]
    bits[1:, 13] = ref[right]
    return torch.from_numpy(table).to(packed.node_boxes.device)


def unpack_child_records(records) -> torch.Tensor:
    """The inverse of :func:`pack_child_records` → ``node_boxes`` [n, 8]
    in the packing's depth-first layout (left child = node + 1, right child
    in ``node_a``), on the CPU."""
    table = np.asarray(torch.as_tensor(records).cpu(), np.float32)
    bits = table.view(np.int32)
    rows, metas = [], []

    def emit(box, ref) -> int:
        node = len(rows)
        rows.append(box)
        metas.append(None)
        if ref < 0:
            leaf = ~int(ref)
            metas[node] = (leaf >> LEAF_COUNT_BITS,
                           (leaf & ((1 << LEAF_COUNT_BITS) - 1)) + 1)
        else:
            emit(table[ref, 0:6], bits[ref, 12])
            metas[node] = (emit(table[ref, 6:12], bits[ref, 13]), 0)
        return node

    emit(table[0, 0:6], bits[0, 12])
    out = np.zeros((len(rows), 8), np.float32)
    out[:, 0:6] = rows
    out[:, 6:8].view(np.int32)[:] = metas
    return torch.from_numpy(out)


def hierarchical_intersect_reference(packed: HierTriangles, origin, direction,
                                     t_min, t_max, any_hit: bool = False,
                                     live_count=None, stats=None) -> Hit:
    """Plain PyTorch version of the kernel: the lockstep traversal over the
    packed tree and its (v0, e1, e2) records. Runs on any device. ``stats``
    is passed to :func:`~bifrost3d_tpu_torch.geometry.traverse.traverse_lockstep`."""
    meta = packed.node_meta
    comp, order = packed.tri_components, packed.order
    last = max(packed.n_tris - 1, 0)

    def fetch_leaf(slot):
        slot = torch.clamp_max(slot, last)
        rec = comp[slot]                                    # [r, K, 12]
        return rec[..., 0:3], rec[..., 3:6], rec[..., 6:9], order[slot]

    return traverse_lockstep(
        packed.node_boxes[:, 0:3], packed.node_boxes[:, 3:6], meta[:, 0],
        meta[:, 1], fetch_leaf, origin, direction, t_min, t_max,
        any_hit=any_hit, live_count=live_count, stats=stats)


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("bvh_intersect.cu")
    lib.bvh_intersect.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.bvh_intersect.restype = ctypes.c_int
    lib.bvh_intersect_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bvh_intersect_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(any_hit: bool = False) -> int:
    """Blocks of ``_THREADS`` that one SM of the card holds at once: the
    kernel's occupancy, from the CUDA runtime."""
    n = _library().bvh_intersect_blocks_per_sm(int(any_hit), _THREADS)
    if n < 0:
        raise RuntimeError(f"bvh_intersect occupancy query failed: "
                           f"cudaError {-n}")
    return n


def hierarchical_intersect_cuda(packed: HierTriangles, origin, direction,
                                t_min, t_max, any_hit: bool = False,
                                live_count=None) -> Hit:
    """Launch ``csrc/bvh_intersect.cu`` on the current stream. The kernel
    reads ``origin`` and ``direction`` [r, 3] as they are, each bound as a
    number, a one-element tensor or an [r] tensor, and a ``live_count``
    tensor (int32 or int64, one element) on the device, so a pool's live
    sum costs no host sync; it writes the final hits into one allocation,
    whose views the returned Hit holds."""
    global launch_count
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    if packed.tri_components.dim() != 2 or packed.tri_components.shape[1] != 12:
        raise ValueError("tri_components must be [T, 12]")
    records = packed.child_records
    if records.dim() != 2 or records.shape[1] != 16 or records.shape[0] < 1:
        raise ValueError("child_records must be [n >= 1, 16]")
    if packed.order.shape != (packed.tri_components.shape[0],):
        raise ValueError("order must hold one id per triangle slot")
    if packed.max_depth + 1 > STACK_SIZE:
        raise ValueError(f"BVH depth {packed.max_depth} exceeds the kernel "
                         f"stack ({STACK_SIZE})")
    if 4 * r + 1 >= 2**31:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    origin, direction = origin.contiguous(), direction.contiguous()
    _check("origin", origin, torch.float32, device)
    _check("direction", direction, torch.float32, device)
    _check("tri_components", packed.tri_components, torch.float32, device)
    _check("child_records", records, torch.float32, device)
    _check("order", packed.order, torch.int32, device)
    # The bound and count tensors stay referenced until the launch is
    # enqueued.
    lo, lo_ptr, lo_stride, _lo = kernel_bound(t_min, r, device, "t_min")
    hi, hi_ptr, hi_stride, _hi = kernel_bound(t_max, r, device, "t_max")
    n_live, live_ptr, live_bits, _live = kernel_live(live_count, r, device)

    out = torch.empty(4 * r + 1, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().bvh_intersect(
        origin.data_ptr(), direction.data_ptr(), r, lo, lo_ptr, lo_stride,
        hi, hi_ptr, hi_stride, n_live, live_ptr, live_bits,
        records.data_ptr(), packed.tri_components.data_ptr(),
        packed.order.data_ptr(), int(any_hit), out.data_ptr(), _THREADS,
        stream)
    if err != 0:
        raise RuntimeError(f"bvh_intersect launch failed: cudaError {err}")
    launch_count += 1
    return Hit(t=out[:r], prim=out[r:2 * r].view(torch.int32),
               u=out[2 * r:3 * r], v=out[3 * r:4 * r])


def hierarchical_intersect(packed: HierTriangles, origin, direction, t_min,
                           t_max, any_hit: bool = False,
                           live_count=None) -> Hit:
    """Nearest hit (or any-hit occlusion) of rays [r, 3] through the packed
    BVH; prim ids are original triangle indices. With ``any_hit`` only
    ``prim >= 0`` is defined. Rays at an index >= ``live_count`` (int or
    int tensor) report misses untraversed.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    kind = origin.device.type
    if kind == "cuda":
        return hierarchical_intersect_cuda(packed, origin, direction, t_min,
                                           t_max, any_hit, live_count)
    if kind == "cpu":
        return hierarchical_intersect_reference(packed, origin, direction,
                                                t_min, t_max, any_hit,
                                                live_count)
    raise ValueError(f"no BVH intersect for tensors on {origin.device}")


def coherence_sort_key(origin, direction, lo, hi):
    """int64 [r] sort key: 18-bit Morton code of the origin quantized to 6
    bits per axis inside the box (lo, hi), then the direction's octant."""
    scale = 63.0 / torch.clamp_min(hi - lo, 1e-20)
    q = torch.clamp((origin - lo) * scale, 0.0, 63.0).to(torch.int64)
    m = morton_encode_3d(q[:, 0], q[:, 1], q[:, 2])
    octant = ((direction[:, 0] < 0).to(torch.int64) * 4
              + (direction[:, 1] < 0).to(torch.int64) * 2
              + (direction[:, 2] < 0).to(torch.int64))
    return (m << 3) | octant


def hierarchical_intersect_sorted(packed: HierTriangles, origin, direction,
                                  t_min, t_max, any_hit: bool = False) -> Hit:
    """:func:`hierarchical_intersect` behind an origin-Morton +
    direction-octant sort of the rays (results scattered back to the input
    order): neighbouring threads then walk neighbouring subtrees. The
    standalone counterpart of the pooled wavefront's in-loop sort."""
    r = origin.shape[0]
    t_min = ray_bounds(t_min, r, origin)
    t_max = ray_bounds(t_max, r, origin)
    key = coherence_sort_key(origin, direction, packed.node_boxes[0, 0:3],
                             packed.node_boxes[0, 3:6])
    order = torch.argsort(key, stable=True)
    hit = hierarchical_intersect(packed, origin[order], direction[order],
                                 t_min[order], t_max[order], any_hit=any_hit)
    inverse = torch.argsort(order)
    return Hit(t=hit.t[inverse], prim=hit.prim[inverse], u=hit.u[inverse],
               v=hit.v[inverse])
