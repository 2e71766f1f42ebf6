"""glTF 2.0 loader (.gltf and .glb).

Port of ``bifrost3d_tpu/io/gltf.py`` (``_load_glb``, ``_load_gltf_json``,
``_read_accessor``, ``_node_matrix``, ``_convert_material``,
``_load_gltf_image``, ``_repack_textures``, ``load_gltf``), the counterpart
of the reference's glTFLoader (``glTFLoader.cpp``), with its rules:
- triangle primitives with POSITION / NORMAL / TEXCOORD_0
  (glTFLoader.cpp:552-570); other topologies are skipped with a warning;
- the node hierarchy, TRS or matrix, flattened into world space; a
  negative determinant flips the winding;
- materials: pbrMetallicRoughness base colour → tint (+ coverage from
  alpha), doubleSided → ThinWalled, alphaMode MASK → Cutout + threshold
  (glTFLoader.cpp:469-475), ``KHR_materials_clearcoat`` → coat,
  ``KHR_materials_emissive_strength`` scales the emission;
- textures repacked from glTF's (base colour + alpha) and (metallic,
  roughness) images into the (tint, roughness) + metallic + coverage
  layout, one set per pair of source images (glTFLoader.cpp:106-133).
A texture set that fails to load is dropped with a warning, as the JAX
package drops it.

An accessor with a ``byteStride`` is read as a strided view of its buffer
(an ``np.ndarray`` with the view's strides), where the JAX package copies it
vertex by vertex: the same array. Images are decoded by
``io.image.decode_image_bytes``: PNG without PIL, other formats through
PIL. A metallic-roughness image of another size than the base image is
resized with PIL, as the JAX package does; without PIL that raises
``NotImplementedError`` (and drops the texture set).
"""

from __future__ import annotations

import base64
import json
import os
import struct
import warnings

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.mesh import TriangleMesh
from bifrost3d_tpu_torch.io.image import decode_image_bytes
from bifrost3d_tpu_torch.math.color import srgb_to_linear

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT4": 16}


def _load_glb(path):
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67, "not a glb file"
        json_data, bin_data = None, b""
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_len, chunk_type = struct.unpack("<II", header)
            chunk = f.read(chunk_len)
            if chunk_type == 0x4E4F534A:
                json_data = json.loads(chunk)
            elif chunk_type == 0x004E4942:
                bin_data = chunk
        return json_data, [bin_data]


def _load_gltf_json(path):
    with open(path) as f:
        doc = json.load(f)
    buffers = []
    base = os.path.dirname(path)
    for buf in doc.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base, uri), "rb") as f:
                buffers.append(f.read())
    return doc, buffers


def _read_accessor(doc, buffers, accessor_index):
    acc = doc["accessors"][accessor_index]
    view = doc["bufferViews"][acc["bufferView"]]
    data = buffers[view.get("buffer", 0)]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    count = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * ncomp
    if stride == dtype.itemsize * ncomp:
        arr = np.frombuffer(data, dtype, count * ncomp, offset).reshape(
            count, ncomp)
    else:
        # Element i at offset + i * stride: a strided view of the buffer.
        arr = np.ndarray((count, ncomp), dtype, buffer=data, offset=offset,
                         strides=(stride, dtype.itemsize))
    if acc.get("normalized"):
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _convert_material(gmat, doc):
    """pbrMetallicRoughness → a material dict (glTFLoader.cpp:440-520)."""
    out = dict(tint=(1.0, 1.0, 1.0), roughness=1.0, metallic=1.0)
    pbr = gmat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    out["tint"] = tuple(base[:3])
    out["coverage"] = base[3]
    out["roughness"] = pbr.get("roughnessFactor", 1.0)
    out["metallic"] = pbr.get("metallicFactor", 1.0)
    flags = 0
    if gmat.get("doubleSided"):
        flags |= 1  # ThinWalled (glTFLoader doubleSided rule)
    alpha_mode = gmat.get("alphaMode", "OPAQUE")
    if alpha_mode == "MASK":
        flags |= 2  # Cutout
        out["coverage"] = gmat.get("alphaCutoff", 0.5)
    elif alpha_mode == "OPAQUE":
        out["coverage"] = 1.0
    out["flags"] = flags
    clearcoat = gmat.get("extensions", {}).get("KHR_materials_clearcoat")
    if clearcoat:
        out["coat"] = clearcoat.get("clearcoatFactor", 0.0)
        out["coat_roughness"] = clearcoat.get("clearcoatRoughnessFactor", 0.0)
    emissive = gmat.get("emissiveFactor")
    if emissive and any(v > 0 for v in emissive):
        strength = gmat.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
        out["emission"] = tuple(v * strength for v in emissive)
    # Texture references for _repack_textures.
    if "baseColorTexture" in pbr:
        out["tint_texture_index"] = pbr["baseColorTexture"]["index"]
    if "metallicRoughnessTexture" in pbr:
        out["metallic_roughness_texture_index"] = \
            pbr["metallicRoughnessTexture"]["index"]
    return out


def _load_gltf_image(doc, buffers, image_index, base_dir):
    """A glTF image (uri file, data uri or bufferView) → float32 [h, w, c]
    in [0, 1], not yet linearised."""
    img = doc["images"][image_index]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            raw, name = base64.b64decode(uri.split(",", 1)[1]), "data uri"
        else:
            name = os.path.join(base_dir, uri)
            with open(name, "rb") as f:
                raw = f.read()
    else:
        view = doc["bufferViews"][img["bufferView"]]
        data = buffers[view.get("buffer", 0)]
        off = view.get("byteOffset", 0)
        raw = data[off:off + view["byteLength"]]
        name = f"image {image_index} (bufferView {img['bufferView']})"
    arr = decode_image_bytes(raw, name).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _resize(mr, w, h):
    """PIL's default resize of an image in [0, 1], as the JAX package's."""
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise NotImplementedError(
            "resizing a metallic-roughness image to its base image's size "
            "needs PIL, which is not installed") from e
    out = np.asarray(PILImage.fromarray((mr * 255).astype(np.uint8)).resize(
        (w, h)))
    out = out.astype(np.float32) / 255.0
    return out[..., None] if out.ndim == 2 else out


def _repack_textures(doc, buffers, base_dir, material_dicts):
    """The reference's channel repacking (glTFLoader.cpp:106-133): glTF
    (base colour rgb + a) and (metallicRoughness g = roughness, b = metal)
    → (tint_roughness rgba) + metallic + coverage textures, one set per
    source-image pair → the texture dicts; ``material_dicts`` get the bank
    indices in place."""
    textures = []
    cache = {}

    def image_of(tex_index):
        return doc["textures"][tex_index].get("source", 0)

    def add_texture(image_array):
        textures.append(dict(image=image_array))
        return len(textures) - 1

    for m in material_dicts:
        base_idx = m.pop("tint_texture_index", None)
        mr_idx = m.pop("metallic_roughness_texture_index", None)
        key = (base_idx, mr_idx)
        if key == (None, None):
            continue
        if key not in cache:
            base = (_load_gltf_image(doc, buffers, image_of(base_idx), base_dir)
                    if base_idx is not None else None)
            mr = (_load_gltf_image(doc, buffers, image_of(mr_idx), base_dir)
                  if mr_idx is not None else None)
            h = base.shape[0] if base is not None else mr.shape[0]
            w = base.shape[1] if base is not None else mr.shape[1]
            # tint (sRGB → linear) + roughness (G of metallicRoughness).
            tr = np.ones((h, w, 4), np.float32)
            if base is not None:
                tr[..., :3] = srgb_to_linear(torch.from_numpy(
                    np.ascontiguousarray(base[..., :3]))).numpy()
            if mr is not None:
                if mr.shape[:2] != (h, w):
                    mr = _resize(mr, w, h)
                tr[..., 3] = mr[..., min(1, mr.shape[-1] - 1)]
            entry = {"tint_roughness": add_texture(tr)}
            if mr is not None:
                entry["metallic"] = add_texture(
                    mr[..., min(2, mr.shape[-1] - 1)][..., None])
            if base is not None and base.shape[-1] == 4:
                entry["coverage"] = add_texture(base[..., 3][..., None])
            cache[key] = entry
        entry = cache[key]
        m["tint_roughness_texture"] = entry["tint_roughness"]
        if "metallic" in entry:
            m["metallic_texture"] = entry["metallic"]
        if "coverage" in entry:
            m["coverage_texture"] = entry["coverage"]
    return textures


def load_gltf(path, load_textures: bool = True):
    """→ (meshes, material_dicts), with ``load_textures`` also the texture
    dicts; meshes = [(TriangleMesh, mat_idx, name)] in world space."""
    if path.lower().endswith(".glb"):
        doc, buffers = _load_glb(path)
    else:
        doc, buffers = _load_gltf_json(path)

    for ignored in ("animations", "skins", "cameras"):
        if doc.get(ignored):
            warnings.warn(f"glTF: ignoring {ignored} (not supported)")

    material_dicts = [
        _convert_material(g, doc) for g in doc.get("materials", [])]
    if not material_dicts:
        material_dicts = [dict(tint=(0.8, 0.8, 0.8), roughness=0.8)]

    texture_dicts = []
    if load_textures and doc.get("textures"):
        try:
            texture_dicts = _repack_textures(
                doc, buffers, os.path.dirname(path), material_dicts)
        except Exception as e:  # a corrupt or unreadable image
            warnings.warn(f"glTF: texture loading failed ({e})")

    meshes = []

    def emit_mesh(mesh_index, world, name):
        mesh = doc["meshes"][mesh_index]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                warnings.warn("glTF: skipping non-triangle primitive")
                continue
            attrs = prim["attributes"]
            if "POSITION" not in attrs:
                continue
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(
                np.float32)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos))
            idx = idx.astype(np.int32).reshape(-1, 3)
            normals = None
            if "NORMAL" in attrs:
                n = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(
                    np.float32)
                inv_t = np.linalg.inv(world[:3, :3]).T
                n = n @ inv_t.T
                n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                                1e-20)
                normals = n
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(
                    np.float32)[:, :2]
            # Negative determinant (mirroring) flips winding.
            if np.linalg.det(world[:3, :3]) < 0:
                idx = idx[:, ::-1]
            meshes.append((TriangleMesh(
                indices=np.ascontiguousarray(idx), positions=pos,
                normals=normals, texcoords=uv), prim.get("material", 0), name))

    def walk(node_index, parent):
        node = doc["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world, node.get("name", f"node{node_index}"))
        for child in node.get("children", []):
            walk(child, world)

    scene_index = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    roots = (scenes[scene_index]["nodes"] if scenes
             else range(len(doc.get("nodes", []))))
    for root in roots:
        walk(root, np.eye(4, dtype=np.float32))

    if load_textures:
        return meshes, material_dicts, texture_dicts
    return meshes, material_dicts
