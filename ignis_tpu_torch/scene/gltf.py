"""glTF 2.0 importer → Scene objects.  Counterpart of
ignis_tpu/scene/gltf.py, whose code it copies; it builds the port's `Scene`.

Counterpart of src/runtime/loader/glTFParser.cpp: nodes/meshes/materials are
converted into the flat scene representation (shapes as inline meshes,
materials as principled BSDFs incl. KHR_materials_{ior,transmission,volume,
emissive_strength,clearcoat,sheen}, KHR_lights_punctual lights, cameras).
Supports .gltf (+ external .bin/data URIs) and .glb containers.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

_COMP_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTF:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.dir = self.path.parent
        if self.path.suffix.lower() == ".glb":
            with open(self.path, "rb") as f:
                data = f.read()
            magic, version, length = struct.unpack_from("<III", data, 0)
            if magic != 0x46546C67:
                raise ValueError("Not a GLB file")
            pos = 12
            self.json = None
            self.bin = b""
            while pos < length:
                clen, ctype = struct.unpack_from("<II", data, pos)
                chunk = data[pos + 8:pos + 8 + clen]
                if ctype == 0x4E4F534A:
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:
                    self.bin = chunk
                pos += 8 + clen + ((-clen) % 4)
        else:
            self.json = json.loads(self.path.read_text())
            self.bin = b""
        self._buffers = {}

    def buffer(self, i):
        if i not in self._buffers:
            b = self.json["buffers"][i]
            uri = b.get("uri")
            if uri is None:
                self._buffers[i] = self.bin
            elif uri.startswith("data:"):
                self._buffers[i] = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote
                self._buffers[i] = (self.dir / unquote(uri)).read_bytes()
        return self._buffers[i]

    def accessor(self, i) -> np.ndarray:
        acc = self.json["accessors"][i]
        n = acc["count"]
        ncomp = _TYPE_SIZE[acc["type"]]
        dt = _COMP_DTYPE[acc["componentType"]]
        itemsize = np.dtype(dt).itemsize * ncomp
        if "bufferView" not in acc:
            out = np.zeros((n, ncomp), dt)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            buf = self.buffer(bv["buffer"])
            off = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride") or itemsize
            if stride == itemsize:
                out = np.frombuffer(buf, dt, n * ncomp, off).reshape(n, ncomp)
            else:
                raw = np.frombuffer(buf, np.uint8)
                rows = np.stack([
                    raw[off + k * stride: off + k * stride + itemsize]
                    for k in range(n)])
                out = rows.view(dt).reshape(n, ncomp)
        out = np.array(out)
        # sparse accessors (glTF 2.0 §3.6.2.3; glTFParser.cpp handles
        # these through tinygltf): substitute `count` rows by index
        sp = acc.get("sparse")
        if sp:
            cnt = sp["count"]
            ibv = self.json["bufferViews"][sp["indices"]["bufferView"]]
            ibuf = self.buffer(ibv["buffer"])
            ioff = ibv.get("byteOffset", 0) + sp["indices"].get(
                "byteOffset", 0)
            idt = _COMP_DTYPE[sp["indices"]["componentType"]]
            idx = np.frombuffer(ibuf, idt, cnt, ioff).astype(np.int64)
            vbv = self.json["bufferViews"][sp["values"]["bufferView"]]
            vbuf = self.buffer(vbv["buffer"])
            voff = vbv.get("byteOffset", 0) + sp["values"].get(
                "byteOffset", 0)
            vals = np.frombuffer(vbuf, dt, cnt * ncomp, voff).reshape(
                cnt, ncomp)
            out[idx] = vals
        if acc.get("normalized") and dt != np.float32:
            info = np.iinfo(dt)
            out = out.astype(np.float32) / info.max
        return out


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        from ignis_tpu_torch.scene.transforms import _quat
        m = _quat(w, x, y, z) @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _material_to_bsdf(gltf, mi, name):
    """pbrMetallicRoughness (+KHR extensions) → principled properties
    (glTFParser.cpp:460-560)."""
    mats = gltf.json.get("materials", [])
    obj = {"type": "principled", "name": name}
    if mi is None or mi >= len(mats):
        obj.update(base_color=[0.8, 0.8, 0.8], roughness=0.5)
        return obj, None, None
    m = mats[mi]
    pbr = m.get("pbrMetallicRoughness", {})
    bc = pbr.get("baseColorFactor", [1, 1, 1, 1])
    obj["base_color"] = bc[:3]
    obj["metallic"] = pbr.get("metallicFactor", 1.0)
    obj["roughness"] = pbr.get("roughnessFactor", 1.0)
    ext = m.get("extensions", {})
    if "KHR_materials_ior" in ext:
        obj["ior"] = ext["KHR_materials_ior"].get("ior", 1.5)
    if "KHR_materials_transmission" in ext:
        obj["specular_transmission"] = \
            ext["KHR_materials_transmission"].get("transmissionFactor", 0.0)
    if "KHR_materials_clearcoat" in ext:
        obj["clearcoat"] = ext["KHR_materials_clearcoat"].get(
            "clearcoatFactor", 0.0)
        obj["clearcoat_roughness"] = ext["KHR_materials_clearcoat"].get(
            "clearcoatRoughnessFactor", 0.0)
    if "KHR_materials_sheen" in ext:
        sc = ext["KHR_materials_sheen"].get("sheenColorFactor", [0, 0, 0])
        obj["sheen"] = float(np.mean(sc))
    # doubleSided: our shading is two-sided by construction (the surface
    # frame flips toward the incident ray, shapes/trimesh.art semantics),
    # matching the reference's twosided wrapper default; single-sided
    # backface culling is not modelled (glTFParser.cpp ignores it too).

    # emissive
    emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
    strength = ext.get("KHR_materials_emissive_strength", {}).get(
        "emissiveStrength", 1.0)
    emissive = emissive * strength
    emissive = emissive if emissive.max() > 0 else None

    medium = None
    if "KHR_materials_volume" in ext:
        vol = ext["KHR_materials_volume"]
        ad = float(vol.get("attenuationDistance", 0.0) or 0.0)
        if ad > 0:
            ac = np.asarray(vol.get("attenuationColor", [1, 1, 1]), np.float32)
            sigma_a = (-np.log(np.maximum(ac, 1e-5)) / ad).tolist()
            medium = {"type": "homogeneous", "sigma_a": sigma_a,
                      "sigma_s": [0.0, 0.0, 0.0], "g": 0.0}
    return obj, emissive, medium


def _texture_for(g, tex_info, name, textures_out):
    """baseColor texture (+ KHR_texture_transform) → scene texture entry.

    Returns the texture name to reference, or None (data-URI images and
    non-file sources are skipped)."""
    if not tex_info or "index" not in tex_info:
        return None
    try:
        tex = g.json["textures"][tex_info["index"]]
        img = g.json["images"][tex["source"]]
    except (KeyError, IndexError):
        return None
    uri = img.get("uri")
    if not uri or uri.startswith("data:"):
        return None
    from urllib.parse import unquote
    entry = {"type": "image", "name": name,
             "filename": str(g.dir / unquote(uri))}
    samplers = g.json.get("samplers", [])
    if "sampler" in tex and tex["sampler"] < len(samplers):
        sm = samplers[tex["sampler"]]
        wrap = {10497: "repeat", 33071: "clamp", 33648: "mirror"}
        if sm.get("wrapS") in wrap:
            entry["wrap_mode_u"] = wrap[sm["wrapS"]]
        if sm.get("wrapT") in wrap:
            entry["wrap_mode_v"] = wrap[sm["wrapT"]]
    # KHR_texture_transform (offset/rotation/scale in UV space)
    tt = tex_info.get("extensions", {}).get("KHR_texture_transform")
    if tt:
        off = tt.get("offset", [0.0, 0.0])
        rot = float(tt.get("rotation", 0.0))
        sc = tt.get("scale", [1.0, 1.0])
        c, s_ = float(np.cos(rot)), float(np.sin(rot))
        # uv' = offset + R(-rot) @ (scale * uv)  (spec composition
        # T * R * S applied to UV coordinates; the reference composes
        # Rotation2Df(-rotation), glTFParser.cpp getTextureTransformExts)
        m = np.asarray([[c * sc[0], s_ * sc[1], off[0]],
                        [-s_ * sc[0], c * sc[1], off[1]]], np.float32)
        entry["transform"] = [float(v) for v in m.reshape(-1)]
    textures_out.append(entry)
    return name


def load_gltf_scene(path):
    """Returns a Scene built from the glTF file."""
    from ignis_tpu_torch.scene.parser import load_scene_dict
    g = GLTF(Path(path))
    doc = g.json

    shapes, bsdfs, entities, lights, media = [], [], [], [], []
    textures = []
    camera = None
    mat_cache = {}

    def get_material(mi):
        if mi in mat_cache:
            return mat_cache[mi]
        name = f"mat_{mi}"
        obj, emissive, medium = _material_to_bsdf(g, mi, name)
        # baseColor texture (+ sampler wrap modes + KHR_texture_transform)
        mats = g.json.get("materials", [])
        if mi is not None and mi < len(mats):
            pbr = mats[mi].get("pbrMetallicRoughness", {})
            tname = _texture_for(g, pbr.get("baseColorTexture"),
                                 f"tex_mat{mi}_base", textures)
            if tname:
                obj["base_color"] = tname
        bsdfs.append(obj)
        med_name = None
        if medium is not None:
            med_name = f"medium_{mi}"
            medium["name"] = med_name
            media.append(medium)
        mat_cache[mi] = (name, emissive, med_name)
        return mat_cache[mi]

    mesh_prims = {}

    def get_mesh_shapes(mesh_i):
        if mesh_i in mesh_prims:
            return mesh_prims[mesh_i]
        out = []
        mesh = doc["meshes"][mesh_i]
        for pi, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            nrm = (g.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
            uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else None)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            faces = idx.reshape(-1, 3)
            sname = f"mesh{mesh_i}_{pi}"
            out.append((sname, pos, faces, nrm, uv, prim.get("material")))
        mesh_prims[mesh_i] = out
        return out

    inline_meshes = {}

    def walk(node_i, parent):
        nonlocal camera
        node = doc["nodes"][node_i]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            for (sname, pos, faces, nrm, uv, mi) in get_mesh_shapes(node["mesh"]):
                mat_name, emissive, med_name = get_material(mi)
                ent_name = f"n{node_i}_{sname}"
                inline_meshes[sname] = (pos, faces, nrm, uv)
                ent = {"name": ent_name, "shape": sname, "bsdf": mat_name,
                       "transform": list(m[:3, :].reshape(-1))}
                if med_name:
                    ent["inner_medium"] = med_name
                entities.append(ent)
                if emissive is not None:
                    lights.append({"type": "area", "name": f"light_{ent_name}",
                                   "entity": ent_name,
                                   "radiance": [float(v) for v in emissive]})
        if "camera" in node and camera is None:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam.get("perspective", {})
                import math as _m
                camera = {
                    "type": "perspective",
                    "vfov": _m.degrees(p.get("yfov", 1.0)),
                    # glTF cameras look down -Z; our camera dir = col(2)
                    "transform": list((m @ np.diag([1, 1, -1, 1]))[:3, :]
                                      .reshape(-1)),
                }
        ext = node.get("extensions", {})
        if "KHR_lights_punctual" in ext:
            li = ext["KHR_lights_punctual"]["light"]
            ldef = doc.get("extensions", {}).get(
                "KHR_lights_punctual", {}).get("lights", [])[li]
            color = ldef.get("color", [1, 1, 1])
            inten = ldef.get("intensity", 1.0)
            pos = (m @ np.asarray([0, 0, 0, 1.0]))[:3]
            ldir = (m[:3, :3] @ np.asarray([0, 0, -1.0]))
            if ldef["type"] == "point":
                lights.append({"type": "point", "name": f"plight{node_i}",
                               "position": [float(v) for v in pos],
                               "intensity": [c * inten for c in color]})
            elif ldef["type"] == "directional":
                lights.append({"type": "directional",
                               "name": f"dlight{node_i}",
                               "direction": [float(v) for v in ldir],
                               "irradiance": [c * inten for c in color]})
            elif ldef["type"] == "spot":
                spot = ldef.get("spot", {})
                import math as _m
                lights.append({
                    "type": "spot", "name": f"slight{node_i}",
                    "position": [float(v) for v in pos],
                    "direction": [float(v) for v in ldir],
                    "intensity": [c * inten for c in color],
                    "cutoff": _m.degrees(spot.get("outerConeAngle", 0.785)),
                    "falloff": _m.degrees(spot.get("innerConeAngle", 0.0))})
        for child in node.get("children", []):
            walk(child, m)

    scene_i = doc.get("scene", 0)
    roots = doc.get("scenes", [{}])[scene_i].get("nodes", [])
    for r in roots:
        walk(r, np.eye(4))

    data = {
        "technique": {"type": "volpath" if media else "path", "max_depth": 8},
        "film": {"size": [800, 600]},
        "shapes": [{"type": "gltf_inline", "name": n} for n in inline_meshes],
        "textures": textures,
        "bsdfs": bsdfs,
        "entities": entities,
        "lights": lights or [{"type": "env", "name": "__env",
                              "radiance": [1.0, 1.0, 1.0]}],
        "media": media,
    }
    if camera is not None:
        data["camera"] = camera
    scene = load_scene_dict(data, Path(path).parent)
    scene.gltf_inline_meshes = inline_meshes
    return scene
