"""Writers of the scene and image files that the port's loaders read: PNG
with a chosen scanline filter, OBJ + MTL, and glTF 2.0 as ``.gltf`` (an
external ``.bin`` or a data-URI buffer) or ``.glb``.

numpy, zlib and json only (no PIL, no JAX), so that ``chip_smoke.py`` writes
its inputs with them on a machine without either. The repository holds no
model files: tests and the smoke script make theirs from seeded numpy.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, filters="paeth") -> bytes:
    """uint8 [h, w] or [h, w, c] (c = 1–4: grey, grey + alpha, RGB, RGBA) →
    an 8-bit PNG whose every row is filtered by ``filters`` (a name of
    FILTERS, or a sequence of names, one a row, repeated)."""
    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    if isinstance(filters, str):
        filters = [filters]
    raw = px.reshape(h, w * c).astype(np.int16)
    left = np.zeros_like(raw)
    left[:, c:] = raw[:, :-c]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    up_left = np.zeros_like(raw)
    up_left[1:, c:] = raw[:-1, :-c]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    preds = [np.zeros_like(raw), left, up, (left + up) >> 1, paeth]
    rows = []
    for y in range(h):
        kind = FILTERS[filters[y % len(filters)]]
        rows.append(bytes([kind]) + ((raw[y] - preds[kind][y]) & 0xFF)
                    .astype(np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
            + _png_chunk(b"IEND", b""))


def _floats(a: np.ndarray) -> np.ndarray:
    """float32 values as decimal strings that read back to the same
    float32 (the float64 of each, to 17 digits)."""
    return np.char.mod("%.17g", np.asarray(a, np.float32).astype(np.float64))


def write_obj(path: str, tri_verts, tri_material, materials,
              tri_normals=None, tri_uvs=None) -> None:
    """A triangle soup as OBJ + MTL: one ``v`` (and ``vt`` / ``vn`` where
    given) per corner, one ``usemtl`` group per material in order of first
    use, each face ``f p/t/n`` with 1-based indices. ``materials``: dicts
    with ``name``, ``Kd`` (3 floats) and optionally ``Ns``, ``illum``,
    ``d``, written to ``<path minus .obj>.mtl``."""
    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w") as f:
        for m in materials:
            f.write(f"newmtl {m['name']}\n")
            f.write("Kd " + " ".join(f"{v:.9g}" for v in m["Kd"]) + "\n")
            for key in ("Ns", "illum", "d"):
                if key in m:
                    f.write(f"{key} {m[key]}\n")
    lines = [f"mtllib {os.path.basename(mtl_path)}"]

    def block(tag, values):
        cols = _floats(values.reshape(3 * t, -1))
        return [f"{tag} " + " ".join(row) for row in cols]
    lines += block("v", tri_verts)
    if tri_uvs is not None:
        lines += block("vt", np.asarray(tri_uvs))
    if tri_normals is not None:
        lines += block("vn", np.asarray(tri_normals))
    corner = np.arange(1, 3 * t + 1).reshape(t, 3).astype(str)
    if tri_uvs is not None and tri_normals is not None:
        corner = np.char.add(np.char.add(np.char.add(corner, "/"), corner),
                             np.char.add("/", corner))
    elif tri_normals is not None:
        corner = np.char.add(np.char.add(corner, "//"), corner)
    elif tri_uvs is not None:
        corner = np.char.add(np.char.add(corner, "/"), corner)
    tri_material = np.asarray(tri_material)
    _, first = np.unique(tri_material, return_index=True)
    for mid in tri_material[np.sort(first)]:
        lines.append(f"usemtl {materials[mid]['name']}")
        faces = corner[tri_material == mid]
        lines += ["f " + " ".join(row) for row in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


class GltfBuilder:
    """A glTF 2.0 document with one binary buffer, built piece by piece."""

    def __init__(self):
        self.doc = {"asset": {"version": "2.0"}, "buffers": [],
                    "bufferViews": [], "accessors": [], "meshes": [],
                    "nodes": [], "scenes": [{"nodes": []}], "scene": 0}
        self.blob = bytearray()

    def view(self, data: bytes, stride=None) -> int:
        """A buffer view over ``data``, 4-byte aligned in the buffer."""
        while len(self.blob) % 4:
            self.blob.append(0)
        v = {"buffer": 0, "byteOffset": len(self.blob),
             "byteLength": len(data)}
        if stride:
            v["byteStride"] = stride
        self.blob += data
        self.doc["bufferViews"].append(v)
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, view: int, component: int, count: int, kind: str,
                 offset: int = 0, normalized: bool = False) -> int:
        a = {"bufferView": view, "componentType": component, "count": count,
             "type": kind}
        if offset:
            a["byteOffset"] = offset
        if normalized:
            a["normalized"] = True
        self.doc["accessors"].append(a)
        return len(self.doc["accessors"]) - 1

    def array(self, values: np.ndarray, component: int, kind: str,
              normalized: bool = False) -> int:
        """A tightly packed accessor of its own view."""
        values = np.ascontiguousarray(values)
        return self.accessor(self.view(values.tobytes()), component,
                             values.shape[0], kind, normalized=normalized)

    def interleaved(self, columns) -> list:
        """float32 columns [n, k_i] in one view of stride 4 Σ k_i →
        one accessor each."""
        n = columns[0].shape[0]
        row = np.concatenate([np.asarray(c, np.float32) for c in columns],
                             axis=1)
        view = self.view(np.ascontiguousarray(row).tobytes(),
                         stride=4 * row.shape[1])
        out, offset = [], 0
        for c in columns:
            k = c.shape[1]
            out.append(self.accessor(view, 5126, n, f"VEC{k}", offset))
            offset += 4 * k
        return out

    def image(self, png: bytes, data_uri: bool = False) -> int:
        """An image in a buffer view, or as a data URI; and a texture of it
        → the texture's index."""
        entry = ({"uri": "data:image/png;base64,"
                  + base64.b64encode(png).decode()} if data_uri else
                 {"bufferView": self.view(png), "mimeType": "image/png"})
        self.doc.setdefault("images", []).append(entry)
        self.doc.setdefault("textures", []).append(
            {"source": len(self.doc["images"]) - 1})
        return len(self.doc["textures"]) - 1

    def material(self, material: dict) -> int:
        self.doc.setdefault("materials", []).append(material)
        return len(self.doc["materials"]) - 1

    def mesh(self, attributes: dict, indices=None, material=None) -> int:
        prim = {"attributes": attributes}
        if indices is not None:
            prim["indices"] = indices
        if material is not None:
            prim["material"] = material
        self.doc["meshes"].append({"primitives": [prim]})
        return len(self.doc["meshes"]) - 1

    def node(self, root: bool = True, **node) -> int:
        self.doc["nodes"].append(node)
        index = len(self.doc["nodes"]) - 1
        if root:
            self.doc["scenes"][0]["nodes"].append(index)
        return index

    def write(self, path: str, buffer: str = "glb") -> None:
        """``buffer``: "glb" (one binary chunk), "bin" (a .gltf and an
        external .bin beside it) or "data" (a .gltf with a data URI)."""
        blob = bytes(self.blob)
        doc = dict(self.doc)
        if buffer == "glb":
            doc["buffers"] = [{"byteLength": len(blob)}]
            js = json.dumps(doc).encode()
            js += b" " * (-len(js) % 4)
            blob += b"\0" * (-len(blob) % 4)
            body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                    + struct.pack("<II", len(blob), 0x004E4942) + blob)
            with open(path, "wb") as f:
                f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)))
                f.write(body)
            return
        if buffer == "bin":
            name = os.path.splitext(os.path.basename(path))[0] + ".bin"
            with open(os.path.join(os.path.dirname(path), name), "wb") as f:
                f.write(blob)
            doc["buffers"] = [{"uri": name, "byteLength": len(blob)}]
        else:
            doc["buffers"] = [{
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode(), "byteLength": len(blob)}]
        with open(path, "w") as f:
            json.dump(doc, f)


def write_textured_glb(path: str, mesh, base_rgba: np.ndarray,
                       metallic_roughness: np.ndarray,
                       alpha_mode: str = "MASK") -> None:
    """One mesh (numpy TriangleMesh with normals and texcoords) as a
    ``.glb``: POSITION, NORMAL and TEXCOORD_0 interleaved in one view of
    stride 32, uint32 indices, and one material whose base colour and
    metallic-roughness textures are Paeth-filtered PNGs in the binary
    chunk."""
    g = GltfBuilder()
    pos, nrm, uv = g.interleaved([mesh.positions, mesh.normals,
                                  mesh.texcoords])
    idx = g.array(np.asarray(mesh.indices, np.uint32).reshape(-1), 5125,
                  "SCALAR")
    base = g.image(encode_png(base_rgba, "paeth"))
    mr = g.image(encode_png(metallic_roughness, "paeth"))
    mat = g.material({
        "pbrMetallicRoughness": {
            "baseColorTexture": {"index": base},
            "metallicRoughnessTexture": {"index": mr},
            "roughnessFactor": 1.0, "metallicFactor": 1.0},
        "alphaMode": alpha_mode, "alphaCutoff": 0.5})
    g.node(mesh=g.mesh({"POSITION": pos, "NORMAL": nrm, "TEXCOORD_0": uv},
                       idx, mat), name="mesh")
    g.write(path, "glb")
