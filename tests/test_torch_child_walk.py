"""The kernels' BVH walk over child records, on the CPU.

``pallas_bvh.pack_child_records`` repacks the BVH as one 64-byte record per
internal node (both children's boxes and references, rows depth-first),
and ``csrc/bvh_walk.cuh::walk`` walks it with one read per step, in the BVH
trace kernel and in the megakernel's BVH branch. The kernels run only on
the card; here the records round-trip to the packing's node table, and a
numpy emulation of the walk, rounded in float32 op by op, visits the nodes
of a near-first walk over the node table in the same order (so the records
change no bit of a hit) and finds the plain version's hits.
"""

import numpy as np
import pytest
import torch

from bifrost3d_tpu_torch.apps.scenes import TEST_SCENES, torus_grid_mesh
from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
import torch_parity  # noqa: F401  (one torch thread per worker)

F = np.float32
BIG = F(3.0e38)


@pytest.fixture(scope="module")
def trees():
    bridge, _ = TEST_SCENES["hier_bridge_50k"](device="cpu")
    torus = torus_grid_mesh(count=28)
    return {
        "bridge": hier.pack_hierarchical(bridge.tri_verts, bridge.bvh),
        "torus": hier.pack_hierarchical(torus.positions[torus.indices])}


@pytest.mark.parametrize("name", ["bridge", "torus"])
def test_child_records_round_trip(trees, name):
    packed = trees[name]
    records = hier.pack_child_records(packed)
    n_nodes = int(packed.node_boxes.shape[0])
    # A binary tree of n nodes has (n - 1) / 2 internal ones, plus the root row.
    assert records.shape == (1 + (n_nodes - 1) // 2, 16)
    assert records.dtype == torch.float32
    assert torch.equal(packed.child_records.view(torch.int32),
                       records.view(torch.int32))
    back = hier.unpack_child_records(records)
    assert torch.equal(back.view(torch.int32), packed.node_boxes.view(torch.int32))
    # Depth-first: row 1 is the root, and an internal left child's row
    # follows its parent's.
    refs = records[:, 12:14].contiguous().view(torch.int32)
    assert int(refs[0, 0]) == 1
    internal = refs[1:] > 0
    parents = torch.nonzero(internal[:, 0])[:, 0] + 1
    assert parents.numel() > 0
    assert torch.equal(refs[parents, 0], parents + 1)


def test_child_records_refuse_a_leaf_they_cannot_encode(trees):
    packed = trees["bridge"]
    meta = packed.node_meta.clone()
    leaf = int(torch.nonzero(meta[:, 1] > 0)[0])
    meta[leaf, 1] = 9
    boxes = packed.node_boxes.clone()
    boxes[:, 6:8] = meta.view(torch.float32)
    with pytest.raises(ValueError, match="more than 8 triangles"):
        hier.pack_child_records(packed._replace(node_boxes=boxes))


# -- a numpy model of the walk, and of a walk over the node table ---------------

def _safe_inv(x):
    return F(-1.0 if x < 0 else 1.0) / max(abs(x), F(1e-12))


def _slab(lo, hi, o, inv, t_min, best_t):
    t0 = [(lo[k] - o[k]) * inv[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv[k] for k in range(3)]
    near = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])),
               max(min(t0[2], t1[2]), t_min))
    far = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])), max(t0[2], t1[2]))
    return near <= far and far > 0 and near < best_t, near


class _Walk:
    """One ray's state and work counts, shared by the two models."""

    def __init__(self, tris, o, d, t_min, t_max):
        self.tris, self.o, self.d, self.t_min = tris, o, d, t_min
        self.inv = [_safe_inv(x) for x in d]
        self.t_max = min(t_max, BIG)
        self.best = (self.t_max, -1, F(0), F(0))
        self.box_tests = self.tri_tests = 0
        self.visits = []

    def slab(self, lo, hi):
        self.box_tests += 1
        return _slab(lo, hi, self.o, self.inv, self.t_min, self.best[0])

    def leaf(self, first, count):
        self.visits.append(("leaf", first))
        o, d = self.o, self.d
        for slot in range(first, first + count):
            self.tri_tests += 1
            v0, e1, e2 = self.tris[slot, 0:3], self.tris[slot, 3:6], self.tris[slot, 6:9]
            p = np.cross(d, e2).astype(F)
            det = F(np.dot(e1, p))
            if not abs(det) > F(1e-9):
                continue
            inv_det = F(1.0) / det
            tv = (o - v0).astype(F)
            u = F(np.dot(tv, p)) * inv_det
            q = np.cross(tv, e1).astype(F)
            v = F(np.dot(d, q)) * inv_det
            t = F(np.dot(e2, q)) * inv_det
            if (u >= 0 and v >= 0 and u + v <= 1 and t > self.t_min
                    and t < self.t_max and t < self.best[0]):
                self.best = (t, slot, u, v)

    def descend(self, left, right, hit_l, near_l, hit_r, near_r, stack, none):
        if hit_l and hit_r:
            right_first = near_r < near_l
            stack.append((left, near_l) if right_first else (right, near_r))
            return right if right_first else left
        return left if hit_l else (right if hit_r else none)

    def pop(self, stack, none):
        while stack:
            ref, near = stack.pop()
            if near < self.best[0]:
                return ref
        return none


def _walk_nodes(packed, w):
    """The near-first walk over the node table: the node's own record
    first, then its children's boxes."""
    boxes = packed.node_boxes[:, 0:6].numpy()
    meta = packed.node_meta.numpy()
    node = 0 if w.slab(boxes[0, :3], boxes[0, 3:])[0] else -1
    stack = []
    while node >= 0:
        a, count = meta[node]
        next_node = -1
        if count > 0:
            w.leaf(int(a), int(count))
        else:
            w.visits.append(("node", node))
            left, right = node + 1, int(a)
            hit_l, near_l = w.slab(boxes[left, :3], boxes[left, 3:])
            hit_r, near_r = w.slab(boxes[right, :3], boxes[right, 3:])
            next_node = w.descend(left, right, hit_l, near_l, hit_r, near_r,
                                  stack, -1)
        node = next_node if next_node >= 0 else w.pop(stack, -1)
    return w


def _walk_children(records, order_of_row, w):
    """``bvh_walk::walk``: one row per step, both children's boxes in it. ``order_of_row`` names a row by its node in the node table, so
    the visits of the two walks compare."""
    table = records.numpy()
    refs = table.view(np.int32)
    ref = int(refs[0, 12]) if w.slab(table[0, 0:3], table[0, 3:6])[0] else 0
    stack = []
    while ref != 0:
        next_ref = 0
        if ref < 0:
            leaf = ~ref
            w.leaf(leaf >> 3, (leaf & 7) + 1)
        else:
            w.visits.append(("node", order_of_row[ref]))
            row = table[ref]
            hit_l, near_l = w.slab(row[0:3], row[3:6])
            hit_r, near_r = w.slab(row[6:9], row[9:12])
            next_ref = w.descend(int(refs[ref, 12]), int(refs[ref, 13]), hit_l,
                                 near_l, hit_r, near_r, stack, 0)
        ref = next_ref if next_ref != 0 else w.pop(stack, 0)
    return w


def _node_of_row(packed, records):
    """Row of the child records → its node in the packing's table."""
    meta = packed.node_meta.numpy()
    refs = records.numpy().view(np.int32)
    node_of, stack = {}, [(0, int(refs[0, 12]))]
    while stack:
        node, ref = stack.pop()
        if ref > 0:
            node_of[ref] = node
            stack += [(node + 1, int(refs[ref, 12])),
                      (int(meta[node, 0]), int(refs[ref, 13]))]
    return node_of


@pytest.fixture(scope="module")
def walked():
    """300 seeded rays through the 3,054-triangle bridge scene's tree, from
    inside its box, each walked both ways, and the plain version's hits."""
    scene, _ = TEST_SCENES["hier_bridge_3k"](device="cpu")
    packed = hier.pack_hierarchical(scene.tri_verts, scene.bvh)
    records = hier.pack_child_records(packed)
    rng = np.random.default_rng(11)
    n = 300
    o = rng.uniform((-1.5, -0.4, -1.5), (1.5, 1.0, 1.5), (n, 3)).astype(F)
    d = rng.normal(size=(n, 3)).astype(F)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(n) % 2 == 0, np.inf, 0.7).astype(F)
    stats = {}
    ref = hier.hierarchical_intersect_reference(
        packed, torch.tensor(o), torch.tensor(d), 1e-4, torch.tensor(t_max),
        stats=stats)
    tris = packed.tri_components.numpy()
    rows = _node_of_row(packed, records)
    walks = []
    for i in range(n):
        by_nodes = _walk_nodes(packed, _Walk(tris, o[i], d[i], F(1e-4), t_max[i]))
        by_rows = _walk_children(records, rows,
                                 _Walk(tris, o[i], d[i], F(1e-4), t_max[i]))
        walks.append((by_nodes, by_rows))
    return packed, walks, ref, stats


def test_both_walks_visit_the_same_nodes(walked):
    _, walks, _, _ = walked
    for by_nodes, by_rows in walks:
        assert by_rows.visits == by_nodes.visits
        assert by_rows.box_tests == by_nodes.box_tests
        assert by_rows.tri_tests == by_nodes.tri_tests
        assert by_rows.best == by_nodes.best


def test_child_walk_finds_the_plain_versions_hits(walked):
    """The plain version walks left-first in lockstep and tests a box when
    it pops the node, the kernels near-first with the children's boxes
    tested at their parent: the same hits (off ties), the same slab rule
    and the same triangles, but not always the same nodes. Its counts
    are held to the walk's: every internal node the near-first walk enters
    costs two box tests in both, so the box tests are 1 + 2 per internal
    node entered, and the triangle tests sum the leaves entered."""
    packed, walks, ref, stats = walked
    order = packed.order.numpy()
    hits = 0
    for i, (_, w) in enumerate(walks):
        t, slot, _, _ = w.best
        prim = -1 if slot < 0 else int(order[slot])
        if prim == int(ref.prim[i]):
            if prim >= 0:
                hits += 1
                np.testing.assert_allclose(t, float(ref.t[i]), rtol=1e-5)
        else:        # a tie: two triangles at the same t
            assert prim >= 0 and int(ref.prim[i]) >= 0
            np.testing.assert_allclose(t, float(ref.t[i]), rtol=1e-6)
    assert hits > 100
    box_tests = sum(w.box_tests for _, w in walks)
    tri_tests = sum(w.tri_tests for _, w in walks)
    nodes = sum(sum(v[0] == "node" for v in w.visits) for _, w in walks)
    assert box_tests == len(walks) + 2 * nodes
    # The near-first walk enters no more nodes than the plain one pops
    # boxes of, on these rays.
    assert 0 < box_tests <= int(stats["box_tests"])
    assert 0 < tri_tests <= int(stats["tri_tests"])


def test_scene_pack_attaches_the_walks_records():
    scene, _ = TEST_SCENES["mid_size"](device="cpu")
    packed = mega._pack_scene(scene)
    tree = packed["tri"]
    assert packed["hier"] and tree.child_records is not None
    assert torch.equal(tree.child_records.view(torch.int32),
                       hier.pack_child_records(tree).view(torch.int32))
    assert mega._pack_scene(scene)["tri"].child_records is tree.child_records
    scene.tri_verts.mul_(1.0)          # an in-place write: a new pack
    assert mega._pack_scene(scene)["tri"].child_records is not tree.child_records
