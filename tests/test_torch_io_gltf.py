"""The glTF loader of the port against the JAX package's.

One document written three ways (``.gltf`` with an external ``.bin``,
``.gltf`` with a data-URI buffer, ``.glb``): a node hierarchy with TRS,
matrix and mirrored (negative determinant) nodes; interleaved (strided),
normalized and tightly packed accessors, uint16 / uint32 / no indices;
OPAQUE, MASK, BLEND, doubleSided, clearcoat and emissive materials; PNG
textures (an RGBA base with a metallic-roughness image, an RGB base alone,
a metallic-roughness image alone, one pair shared by two materials) in
buffer views and as data URIs. Meshes and material dicts are exact, the
repacked texels exact but for the sRGB decode of the tint, which is held
against JAX's through ``assert_f64_anchored``.
"""

import sys
import warnings

import numpy as np
import pytest
import torch

from bifrost3d_tpu.io import gltf as jgltf
from bifrost3d_tpu.math import color as jcolor

from bifrost3d_tpu_torch.io import gltf as tgltf
from bifrost3d_tpu_torch.math import color as tcolor
from torch_parity import assert_f64_anchored
from torch_scene_files import GltfBuilder, encode_png

BUFFERS = ("bin", "data", "glb")


def _quad_grid(n=3):
    """An n × n grid of quads in the unit square: positions, normals, uvs,
    uint16 indices."""
    ys, xs = np.mgrid[0:n + 1, 0:n + 1] / n
    pos = np.stack([xs, ys, 0.1 * xs * ys], -1).reshape(-1, 3)
    nrm = np.tile([0.0, 0.0, 1.0], (pos.shape[0], 1))
    uv = np.stack([xs, 1 - ys], -1).reshape(-1, 2)
    i = np.arange(n * n)
    corner = (i // n) * (n + 1) + i % n
    idx = np.stack([corner, corner + 1, corner + n + 2,
                    corner, corner + n + 2, corner + n + 1], -1)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            uv.astype(np.float32), idx.reshape(-1).astype(np.uint16))


def _document(data_uri_images=False, mr_size=16):
    rng = np.random.default_rng(11)
    g = GltfBuilder()
    pos, nrm, uv, idx = _quad_grid()
    # Mesh 0: interleaved POSITION / NORMAL / TEXCOORD_0, uint16 indices.
    a_pos, a_nrm, a_uv = g.interleaved([pos, nrm, uv])
    a_idx16 = g.array(idx, 5123, "SCALAR")
    # Mesh 1: packed positions, int16-normalized normals, uint16-normalized
    # uvs, uint32 indices.
    b_pos = g.array(pos * 2.0 - 1.0, 5126, "VEC3")
    b_nrm = g.array(np.round(nrm * 32767).astype(np.int16), 5122, "VEC3",
                    normalized=True)
    b_uv = g.array(np.round(uv * 65535).astype(np.uint16), 5123, "VEC2",
                   normalized=True)
    b_idx32 = g.array(idx.astype(np.uint32), 5125, "SCALAR")
    # Mesh 2: positions only, no indices (a triangle list).
    c_pos = g.array(rng.uniform(-1, 1, (9, 3)).astype(np.float32), 5126,
                    "VEC3")

    base = g.image(encode_png(rng.integers(0, 256, (16, 16, 4)), "paeth"),
                   data_uri=data_uri_images)
    mr = g.image(encode_png(rng.integers(0, 256, (mr_size, mr_size, 3)),
                            ["up", "average"]))
    rgb = g.image(encode_png(rng.integers(0, 256, (8, 12, 3)), "sub"))
    mats = [
        g.material({"pbrMetallicRoughness": {
            "baseColorFactor": [0.5, 0.6, 0.7, 0.8],
            "baseColorTexture": {"index": base},
            "metallicRoughnessTexture": {"index": mr}},
            "alphaMode": "MASK", "alphaCutoff": 0.3}),
        g.material({"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.2, 0.1, 0.4], "metallicFactor": 0.0,
            "roughnessFactor": 0.35, "baseColorTexture": {"index": rgb}},
            "alphaMode": "BLEND", "doubleSided": True}),
        g.material({"pbrMetallicRoughness": {
            "metallicRoughnessTexture": {"index": mr}, "metallicFactor": 0.5},
            "extensions": {"KHR_materials_clearcoat": {
                "clearcoatFactor": 0.7, "clearcoatRoughnessFactor": 0.2}}}),
        g.material({"emissiveFactor": [1.0, 0.5, 0.0],
                    "extensions": {"KHR_materials_emissive_strength": {
                        "emissiveStrength": 6.0}}}),
        g.material({"pbrMetallicRoughness": {
            "baseColorTexture": {"index": base},
            "metallicRoughnessTexture": {"index": mr}},
            "emissiveFactor": [0.0, 0.0, 0.0]}),
    ]
    m0 = g.mesh({"POSITION": a_pos, "NORMAL": a_nrm, "TEXCOORD_0": a_uv},
                a_idx16, mats[0])
    m1 = g.mesh({"POSITION": b_pos, "NORMAL": b_nrm, "TEXCOORD_0": b_uv},
                b_idx32, mats[1])
    m2 = g.mesh({"POSITION": c_pos}, None, mats[2])
    m3 = g.mesh({"POSITION": a_pos, "TEXCOORD_0": a_uv}, a_idx16, mats[3])
    m4 = g.mesh({"POSITION": b_pos, "NORMAL": b_nrm}, b_idx32, mats[4])
    child = g.node(root=False, mesh=m1, name="child",
                   translation=[0.0, 0.5, 0.0])
    g.node(mesh=m0, name="trs", translation=[1.0, 2.0, 3.0],
           rotation=[0.0, 0.38268343, 0.0, 0.92387953],
           scale=[2.0, 1.0, 0.5], children=[child])
    g.node(mesh=m2, matrix=[1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0,
                            4, 5, 6, 1])
    g.node(mesh=m3, name="mirrored", scale=[-1.0, 1.0, 1.0])
    g.node(mesh=m4)
    return g


def _assert_same(got, ref):
    meshes, mats, textures = got
    ref_meshes, ref_mats, ref_textures = ref
    assert mats == ref_mats
    assert len(meshes) == len(ref_meshes)
    for (mesh, idx, name), (ref_mesh, ref_idx, ref_name) in zip(meshes,
                                                               ref_meshes):
        assert (idx, name) == (ref_idx, ref_name)
        for field in ("indices", "positions", "normals", "texcoords"):
            a, b = getattr(mesh, field), getattr(ref_mesh, field)
            assert (a is None) == (b is None), field
            if a is not None:
                b = np.asarray(b)
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, field)
    assert len(textures) == len(ref_textures)
    for tex, ref_tex in zip(textures, ref_textures):
        a, b = tex["image"], np.asarray(ref_tex["image"])
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.shape[-1] == 4:       # tint (sRGB decoded) + roughness
            np.testing.assert_array_equal(a[..., 3], b[..., 3])
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("buffer", BUFFERS)
def test_load_gltf_matches_jax(buffer, tmp_path):
    path = str(tmp_path / ("scene.glb" if buffer == "glb" else "scene.gltf"))
    _document(data_uri_images=buffer == "data").write(path, buffer)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tgltf.load_gltf(path)
    ref = jgltf.load_gltf(path)
    _assert_same(got, ref)
    meshes, mats, textures = got
    assert len(meshes) == 5
    # The mirrored node's winding is flipped, the matrix node's is not.
    pos, _, _, idx = _quad_grid()
    np.testing.assert_array_equal(meshes[3][0].indices,
                                  idx.reshape(-1, 3)[:, ::-1])
    np.testing.assert_array_equal(meshes[2][0].indices,
                                  np.arange(9).reshape(3, 3))
    # Six textures: (base, mr) → tint-roughness, metallic, coverage, then
    # the RGB base alone → tint-roughness; mr alone → tint-roughness and
    # metallic; the second (base, mr) material reuses the first set.
    assert len(textures) == 6
    assert mats[0]["flags"] == 2 and mats[0]["coverage"] == 0.3
    assert (mats[0]["tint_roughness_texture"], mats[0]["metallic_texture"],
            mats[0]["coverage_texture"]) == (0, 1, 2)
    assert mats[1]["flags"] == 1 and mats[1]["coverage"] == 0.4
    assert "coverage_texture" not in mats[1]
    assert mats[2]["coat"] == 0.7 and mats[2]["coat_roughness"] == 0.2
    assert mats[3]["emission"] == (6.0, 3.0, 0.0)
    assert mats[4]["tint_roughness_texture"] == 0 and "emission" not in mats[4]
    # The tint of each tint-roughness texture is srgb_to_linear of its base
    # image (images 0 and 2; none behind texture 4, whose tint stays 1).
    doc, buffers = (tgltf._load_glb(path) if buffer == "glb"
                    else tgltf._load_gltf_json(path))
    for texture, image in ((0, 0), (3, 2), (4, None)):
        tint = textures[texture]["image"][..., :3]
        if image is None:
            np.testing.assert_array_equal(tint, 1.0)
            continue
        base = tgltf._load_gltf_image(doc, buffers, image, str(tmp_path))
        np.testing.assert_array_equal(tint, tcolor.srgb_to_linear(
            torch.tensor(np.ascontiguousarray(base[..., :3]))).numpy())


def test_tint_decode_matches_jax(tmp_path):
    """The repacked tint is srgb_to_linear of the base image, the same
    function as JAX's to float64 and within JAX's float32 error."""
    path = str(tmp_path / "scene.glb")
    _document().write(path, "glb")
    doc, buffers = tgltf._load_glb(path)
    base = tgltf._load_gltf_image(doc, buffers, 0, str(tmp_path))
    np.testing.assert_array_equal(
        base, np.asarray(jgltf._load_gltf_image(doc, buffers, 0,
                                                str(tmp_path))))
    assert_f64_anchored(tcolor.srgb_to_linear, jcolor.srgb_to_linear,
                        np.ascontiguousarray(base[..., :3]))


def test_strided_accessor_is_jax_array(tmp_path):
    """A view of stride 40 holding VEC3 at offset 4 and uint8 VEC2 at 16:
    the port's strided read is JAX's per-vertex copy."""
    rng = np.random.default_rng(3)
    rows = np.zeros((37, 40), np.uint8)
    vec3 = rng.normal(size=(37, 3)).astype(np.float32)
    rows[:, 4:16] = vec3.view(np.uint8).reshape(37, 12)
    rows[:, 16:18] = rng.integers(0, 256, (37, 2))
    g = GltfBuilder()
    view = g.view(rows.tobytes(), stride=40)
    acc = [g.accessor(view, 5126, 37, "VEC3", offset=4),
           g.accessor(view, 5121, 37, "VEC2", offset=16),
           g.accessor(view, 5121, 37, "VEC2", offset=16, normalized=True)]
    for a in acc:
        got = tgltf._read_accessor(g.doc, [bytes(g.blob)], a)
        ref = jgltf._read_accessor(g.doc, [bytes(g.blob)], a)
        assert got.dtype == ref.dtype and got.flags.writeable
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tgltf._read_accessor(g.doc, [bytes(g.blob)], acc[0]), vec3)


def test_metallic_roughness_of_another_size(tmp_path, monkeypatch):
    """JAX resizes the metallic-roughness image with PIL, and so does the
    port where PIL is installed; without PIL the port raises inside the
    texture step, which drops the textures with JAX's warning."""
    path = str(tmp_path / "scene.glb")
    _document(mr_size=8).write(path, "glb")
    _assert_same(tgltf.load_gltf(path), jgltf.load_gltf(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.warns(UserWarning, match="texture loading failed .*needs PIL"):
        meshes, mats, textures = tgltf.load_gltf(path)
    assert textures == [] and len(meshes) == 5


def test_ignored_parts_warn(tmp_path):
    g = _document()
    g.doc["animations"] = [{"channels": [], "samplers": []}]
    g.doc["meshes"][2]["primitives"][0]["mode"] = 1     # lines
    path = str(tmp_path / "scene.glb")
    g.write(path, "glb")
    with pytest.warns(UserWarning) as record:
        meshes, _, _ = tgltf.load_gltf(path)
    messages = [str(r.message) for r in record]
    assert any("animations" in m for m in messages)
    assert any("non-triangle" in m for m in messages)
    assert len(meshes) == 4
    with pytest.warns(UserWarning):
        ref = jgltf.load_gltf(path)
    _assert_same((meshes, *tgltf.load_gltf(path)[1:]), ref)
    meshes, mats = tgltf.load_gltf(path, load_textures=False)
    assert all("tint_texture_index" in m or "metallic_roughness_texture_index"
               in m for m in mats if m is not mats[3])
