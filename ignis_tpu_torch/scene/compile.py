"""Scene compiler: parsed Scene -> flat numpy tables + static config.

Counterpart of ignis_tpu/scene/compile.py and table-for-table identical to it
for every scene of the ported slice: a world-space triangle soup (entity
transforms baked in), the instancing split (a shape used by two or more
entities keeps one local copy plus transform records, `CompiledScene.instanced`),
analytic sphere records (`sph_rows`), array-of-struct material/light parameter
tables, and a static `CompiledScene` the integrator specialises on.

`check_slice` rejects what compiles but the integrator does not cover (a
light selector, BSDF type or normal modifier kind outside the ported set),
with `NotImplementedError`.  Nothing is silently skipped or approximated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ignis_tpu_torch.scene.mesh import TriMesh
from ignis_tpu_torch.scene.parser import Scene, SceneError, load_scene_file, load_scene_string
from ignis_tpu_torch.scene.shapes import build_shape
from ignis_tpu_torch.scene.transforms import normal_matrix, parse_transform

DEG2RAD = math.pi / 180.0

# BSDF type ids (dispatch indices for the batched material switch)
BSDF_DIFFUSE = 0       # lambert / oren-nayar   (bsdf/diffuse.art)
BSDF_DIELECTRIC = 1    # smooth/rough/thin      (bsdf/dielectric.art)
BSDF_CONDUCTOR = 2     # smooth/rough           (bsdf/conductor.art)
BSDF_PHONG = 3         # bsdf/phong.art
BSDF_PLASTIC = 4       # bsdf/plastic.art
BSDF_PRINCIPLED = 5    # bsdf/principled.art
BSDF_PASSTHROUGH = 6   # null bsdf
BSDF_MIRROR = 7        # perfect mirror (bsdf/conductor.art make_mirror_bsdf)
BSDF_KLEMS = 8
BSDF_TENSORTREE = 9
BSDF_DJMEASURED = 10
BSDF_ROUGH_CONDUCTOR = 11   # VNDF-GGX conductor (bsdf/conductor.art:34-100)
BSDF_ROUGH_DIELECTRIC = 12  # VNDF-GGX dielectric (bsdf/dielectric.art:51-185)
BSDF_ROUGH_PLASTIC = 13     # plastic with rough specular lobe

# Light type ids
LIGHT_POINT = 0
LIGHT_AREA_PLANE = 1   # spherical-rectangle sampled plane (light/area.art:119-244)
LIGHT_AREA_MESH = 2    # uniform-triangle sampled mesh (light/area.art:45-90)
LIGHT_ENV = 3          # constant/naive-textured env, equal-area sphere sampling
LIGHT_ENV_CDF = 4      # textured env with 2D CDF importance sampling
LIGHT_DIRECTIONAL = 5
LIGHT_SPOT = 6
LIGHT_SUN = 7
LIGHT_AREA_SPHERE = 8

_DIELECTRICS = {
    "vacuum": 1.0, "bk7": 1.5046, "glass": 1.5046, "helium": 1.00004,
    "hydrogen": 1.00013, "air": 1.000277, "water": 1.333, "ethanol": 1.361,
    "diamond": 2.419, "polypropylene": 1.49,
}

_CONDUCTORS = {
    # name: (eta rgb, kappa rgb) — src/runtime/bsdf/BSDF.cpp:29-42
    "aluminum": ((1.34560, 0.96521, 0.61722), (7.47460, 6.39950, 5.30310)),
    "brass": ((0.44400, 0.52700, 1.09400), (3.69500, 2.76500, 1.82900)),
    "copper": ((0.27105, 0.67693, 1.31640), (3.60920, 2.62480, 2.29210)),
    "gold": ((0.18299, 0.42108, 1.37340), (3.42420, 2.34590, 1.77040)),
    "iron": ((2.91140, 2.94970, 2.58450), (3.08930, 2.93180, 2.76700)),
    "lead": ((1.91000, 1.83000, 1.44000), (3.51000, 3.40000, 3.18000)),
    "mercury": ((2.07330, 1.55230, 1.06060), (5.33830, 4.65100, 3.86280)),
    "platinum": ((2.37570, 2.08470, 1.84530), (4.26550, 3.71530, 3.13650)),
    "silver": ((0.15943, 0.14512, 0.13547), (3.92910, 3.19000, 2.38080)),
    "titanium": ((2.74070, 2.54180, 2.26700), (3.81430, 3.43450, 3.03850)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}


def _color(v, default=(0.0, 0.0, 0.0)):
    """Resolve a color property: scalar, [r,g,b], or (later) texture ref."""
    if v is None:
        return np.asarray(default, dtype=np.float32), -1
    if isinstance(v, (int, float)):
        return np.full(3, float(v), dtype=np.float32), -1
    if isinstance(v, list):
        a = np.asarray([float(x) for x in v[:3]], dtype=np.float32)
        if a.size == 1:
            a = np.full(3, a[0], dtype=np.float32)
        return a, -1
    if isinstance(v, str):
        # texture/PExpr reference, resolved by the texture system
        return np.asarray(default, dtype=np.float32), v
    raise SceneError(f"Cannot interpret color property {v!r}")


_PARAM_VALUES: dict = {}


def _number(v, default=0.0):
    if v is None:
        return float(default), -1
    if isinstance(v, (int, float)):
        return float(v), -1
    if isinstance(v, str):
        # constant-fold the PExpr with the scene parameters on CPU tensors;
        # whatever fails keeps the reference (as the JAX package does)
        try:
            import torch
            from ignis_tpu_torch.texture.pexpr import eval_pexpr

            class _S:
                textures = []
                parameter_values = _PARAM_VALUES
            kind, val = eval_pexpr(_S(), {}, v,
                                   {"uv": torch.zeros((1, 2))})
            arr = np.asarray(val.detach().cpu().numpy())
            if arr.size >= 1:
                return float(arr.reshape(-1)[0]), -1
        except Exception:
            pass
        return float(default), v
    raise SceneError(f"Cannot interpret number property {v!r}")


@dataclass
class CameraConfig:
    type: str
    eye: np.ndarray
    dir: np.ndarray
    up: np.ndarray
    scale: np.ndarray       # (sw, sh) from tan(fov/2)
    tmin: float
    tmax: float
    aperture_radius: float = 0.0
    focal_length: float = 1.0
    fishlens_mode: str = "circular"


@dataclass
class TechniqueConfig:
    type: str = "path"
    max_depth: int = 64
    min_depth: int = 2
    clamp: float = 0.0
    enable_nee: bool = True
    light_selector: str = "uniform"
    aov_mis: bool = False
    # debug / ao specific
    debug_mode: str = "normal"
    ao_radius: float = 0.0
    # photonmapper (PhotonMappingTechnique.cpp:14-20)
    photons: int = 1000000
    merge_radius: float = 0.01   # fraction of scene diameter
    max_light_depth: int = 8


@dataclass
class LightInfo:
    """Static per-light record; array data lives in CompiledScene.tables."""
    type: int
    name: str
    infinite: bool
    delta: bool
    entity: int = -1           # for area lights
    tri_offset: int = 0        # into light-triangle arrays (mesh area)
    tri_count: int = 0
    draws: int = 2             # rnd draws consumed by sample_direct
    tex: int = -1              # env radiance texture id (-1 = constant)


@dataclass(eq=False)  # identity hash: used as a static jit argument
class CompiledScene:
    width: int
    height: int
    sampler: str
    camera: CameraConfig
    technique: TechniqueConfig
    bsdf_types: list            # static per-material python ints
    lights: list                # list[LightInfo]; finite first? (see order note)
    num_entities: int
    tables: dict                # name -> np.ndarray (device tables)
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    entity_names: list = field(default_factory=list)
    material_names: list = field(default_factory=list)
    textures: list = field(default_factory=list)
    media: list = field(default_factory=list)

    @property
    def num_lights(self):
        return len(self.lights)

    @property
    def infinite_light_ids(self):
        return [i for i, l in enumerate(self.lights) if l.infinite]

    def scene_radius(self) -> float:
        d = self.bbox_max - self.bbox_min
        return float(np.linalg.norm(d) * 0.5)

    def scene_center(self) -> np.ndarray:
        return (self.bbox_max + self.bbox_min) * 0.5


def _compile_camera(scene: Scene, width: int, height: int) -> CameraConfig:
    cam = scene.camera
    ctype = cam.get("type", "perspective")
    t = parse_transform(cam.get("transform")) if "transform" in cam else None
    if t is not None:
        eye = t[:3, 3].copy()
        cdir = t[:3, 2].copy()
        up = t[:3, 1].copy()
        auto_frame = False
    else:
        eye = np.zeros(3)
        cdir = np.array([0.0, 0.0, -1.0])
        up = np.array([0.0, 1.0, 0.0])
        auto_frame = True

    # FOV semantics: Camera::extractFOV (src/runtime/camera/Camera.cpp:5-15)
    if "vfov" in cam:
        fov, vertical = float(cam["vfov"]) * DEG2RAD, True
    elif "hfov" in cam:
        fov, vertical = float(cam["hfov"]) * DEG2RAD, False
    else:
        fov, vertical = float(cam.get("fov", 60.0)) * DEG2RAD, False
    aspect = float(cam.get("aspect_ratio", width / height))
    if ctype == "orthogonal":
        # OrthogonalCamera.cpp:16,44: scale property, sh = scale / aspect
        sw = float(cam.get("scale", 1.0))
        sh = sw / aspect
    elif ctype == "fishlens":
        # fishlens uses the film size, not a fov scale
        sw, sh = float(width), float(height)
    elif vertical:
        sh = math.tan(fov / 2)
        sw = sh * aspect
    else:
        sw = math.tan(fov / 2)
        sh = sw / aspect

    near = float(cam.get("near_clip", 0.0))
    far = float(cam.get("far_clip", 3.4028235e38))
    if far < near:
        near, far = far, near
    cc = CameraConfig(
        type=ctype, eye=eye.astype(np.float32), dir=cdir.astype(np.float32),
        up=up.astype(np.float32),
        scale=np.array([sw, sh], dtype=np.float32), tmin=near, tmax=far,
        aperture_radius=float(cam.get("aperture_radius", 0.0)),
        focal_length=float(cam.get("focal_length", 1.0)),
        fishlens_mode=cam.get("mode", "circular"))
    cc.auto_frame = auto_frame
    cc.fov = fov
    cc.fov_vertical = vertical
    cc.aspect = aspect
    return cc


def _compile_technique(scene: Scene) -> TechniqueConfig:
    tech = scene.technique
    return TechniqueConfig(
        type=tech.get("type", "path"),
        max_depth=int(tech.get("max_depth", 64)),
        min_depth=int(tech.get("min_depth", 2)),
        clamp=float(tech.get("clamp", 0.0)),
        enable_nee=bool(tech.get("nee", True)),
        light_selector=tech.get("light_selector", "uniform") or "uniform",
        aov_mis=bool(tech.get("aov_mis", False)),
        debug_mode=tech.get("mode", "normal"),
        ao_radius=float(tech.get("radius", 0.0)),
        photons=max(100, int(tech.get("photons", 1000000))),
        merge_radius=float(tech.get("radius", 0.01)),
        max_light_depth=int(tech.get("max_light_depth", 8)),
    )


def _roughness_alphas(obj: dict):
    """setupRoughness + compute_explicit (BSDF.cpp:53-100,
    microfacet.art:397-402): roughness/alpha (+anisotropic or _u/_v) →
    (alpha_u, alpha_v).  Returns (0, 0) for the smooth/delta case."""
    old = any(k in obj for k in ("alpha", "alpha_u", "alpha_v"))
    base = "alpha" if old else "roughness"
    if not any(k in obj for k in (base, base + "_u", base + "_v")):
        return 0.0, 0.0
    if (base + "_u") in obj or (base + "_v") in obj:
        au, _ = _number(obj.get(base + "_u"), 0.1)
        av, _ = _number(obj.get(base + "_v"), 0.1)
        return au, av
    r, _ = _number(obj.get(base), 0.1)
    aniso, _ = _number(obj.get("anisotropic"), 0.0)
    aspect = 1.0 if aniso == 0 else math.sqrt(1.0 - min(max(aniso, 0.0), 1.0) * 0.99)
    return r / aspect, r * aspect


def _is_delta_alpha(au, av):
    return au <= 1e-4 or av <= 1e-4  # check_if_delta_distribution


def _compile_bsdf(obj: dict, colors: np.ndarray, scalars: np.ndarray,
                  tex_row: np.ndarray, tex_of):
    """Fill one material row. colors: (4,3); scalars: (8,). Returns type id.

    Scalar slots: [0]=alpha_u/alpha/exponent, [1]=ext_ior, [2]=int_ior,
    [3]=thin flag, [4]=alpha_v.
    Texture row: per color-slot texture id (-1 = constant) — the compile-time
    analog of ShadingTree's embed-vs-lookup decision (loader/ShadingTree.h:16-63).
    """
    def ccolor(slot, prop, default):
        c, tex = _color(obj.get(prop), default)
        colors[slot] = c
        if isinstance(tex, str):
            tex_row[slot] = tex_of(tex)
    btype = obj.get("type", "diffuse")
    if btype in ("diffuse", "roughdiffuse"):
        ccolor(0, "reflectance", (0.5, 0.5, 0.5))
        alpha, _ = _number(obj.get("alpha", obj.get("roughness")), 0.0)
        scalars[0] = alpha
        return BSDF_DIFFUSE
    if btype in ("dielectric", "roughdielectric", "thindielectric", "glass"):
        ccolor(0, "specular_reflectance", (1, 1, 1))
        ccolor(1, "specular_transmittance", (1, 1, 1))
        ext_def = _DIELECTRICS.get(str(obj.get("ext_ior_material", "")).lower(), 1.0)
        int_def = _DIELECTRICS.get(str(obj.get("int_ior_material", "")).lower(), 1.5046)
        scalars[1], _ = _number(obj.get("ext_ior"), ext_def)
        scalars[2], _ = _number(obj.get("int_ior"), int_def)
        scalars[3] = 1.0 if (btype == "thindielectric" or obj.get("thin", False)) else 0.0
        au, av = (0.0, 0.0) if btype == "glass" else _roughness_alphas(obj)
        scalars[0], scalars[4] = au, av
        if not _is_delta_alpha(au, av):
            return BSDF_ROUGH_DIELECTRIC
        return BSDF_DIELECTRIC
    if btype in ("conductor", "roughconductor", "mirror"):
        if btype == "mirror":
            ks, _ = _color(obj.get("specular_reflectance"), (1, 1, 1))
            colors[0] = ks
            colors[1] = np.zeros(3, np.float32)   # eta = 0
            colors[2] = np.ones(3, np.float32)    # k = 1  -> perfect mirror
            scalars[0] = 0.0
            return BSDF_CONDUCTOR
        spec = _CONDUCTORS.get(str(obj.get("material", "")).lower(), _CONDUCTORS["none"])
        ccolor(0, "specular_reflectance", (1, 1, 1))
        ccolor(1, "eta", spec[0])
        ccolor(2, "k", spec[1])
        au, av = _roughness_alphas(obj)
        scalars[0], scalars[4] = au, av
        if not _is_delta_alpha(au, av):
            return BSDF_ROUGH_CONDUCTOR
        return BSDF_CONDUCTOR
    if btype in ("plastic", "roughplastic"):
        ccolor(0, "diffuse_reflectance", (0.8, 0.8, 0.8))
        ccolor(1, "specular_reflectance", (1, 1, 1))
        ext_def = _DIELECTRICS.get(str(obj.get("ext_ior_material", "")).lower(), 1.0)
        int_def = _DIELECTRICS.get(str(obj.get("int_ior_material", "")).lower(), 1.49)
        scalars[1], _ = _number(obj.get("ext_ior"), ext_def)
        scalars[2], _ = _number(obj.get("int_ior"), int_def)
        au, av = _roughness_alphas(obj)
        scalars[0], scalars[4] = au, av
        if not _is_delta_alpha(au, av):
            return BSDF_ROUGH_PLASTIC
        return BSDF_PLASTIC
    if btype == "principled":
        # PrincipledBSDF.cpp:19-40 defaults; roughness remap via
        # principled::compute_roughness (alpha = roughness^2 with 0.9 aniso)
        ccolor(0, "base_color", (0.8, 0.8, 0.8))
        ior_def = _DIELECTRICS.get(str(obj.get("ior_material", "")).lower(), 1.55)
        scalars[1], _ = _number(obj.get("ior"), ior_def)
        scalars[5], _ = _number(obj.get("diffuse_transmission"), 0.0)
        scalars[6], _ = _number(obj.get("specular_transmission"), 0.0)
        scalars[7], _ = _number(obj.get("specular_tint"), 0.0)
        if "roughness_u" in obj or "roughness_v" in obj:
            ru, _ = _number(obj.get("roughness_u"), 0.5)
            rv, _ = _number(obj.get("roughness_v"), 0.5)
            scalars[0], scalars[4] = ru, rv
        else:
            r, _ = _number(obj.get("roughness"), 0.5)
            aniso, _ = _number(obj.get("anisotropic"), 0.0)
            aspect = 1.0 if aniso == 0 else math.sqrt(
                1.0 - min(max(aniso, 0.0), 1.0) * 0.9)
            scalars[0] = r * r / aspect
            scalars[4] = r * r * aspect
        scalars[8], _ = _number(obj.get("flatness"), 0.0)
        scalars[9], _ = _number(obj.get("metallic"), 0.0)
        scalars[10], _ = _number(obj.get("sheen"), 0.0)
        scalars[11], _ = _number(obj.get("sheen_tint"), 0.0)
        scalars[12], _ = _number(obj.get("clearcoat"), 0.0)
        scalars[13], _ = _number(obj.get("clearcoat_gloss"), 0.0)
        scalars[14], _ = _number(obj.get("clearcoat_roughness"), 0.1)
        scalars[3] = 1.0 if obj.get("thin", False) else 0.0
        scalars[15] = 1.0 if obj.get("clearcoat_top_only", True) else 0.0
        return BSDF_PRINCIPLED
    if btype in ("phong",):
        ccolor(0, "specular_reflectance", (1, 1, 1))
        scalars[0], _ = _number(obj.get("exponent"), 30.0)
        return BSDF_PHONG
    if btype == "klems":
        ccolor(0, "base_color", (1, 1, 1))
        return BSDF_KLEMS
    if btype == "tensortree":
        ccolor(0, "base_color", (1, 1, 1))
        return BSDF_TENSORTREE
    if btype == "djmeasured":
        # DJMeasuredBSDF.cpp:32 — tint defaults to white
        ccolor(0, "tint", (1, 1, 1))
        return BSDF_DJMEASURED
    if btype in ("passthrough", "null"):
        return BSDF_PASSTHROUGH
    # Unknown → signal-pink error BSDF semantics (ErrorBSDF.cpp): bright diffuse
    colors[0] = np.asarray([1.0, 0.0, 1.0], np.float32)
    return BSDF_DIFFUSE


_WRAPPER_TYPES = ("add", "blend", "mix", "mask", "cutoff", "bumpmap",
                  "normalmap", "transform", "twosided", "doublesided")


def _flatten_bsdf(scene, obj: dict, depth: int = 0) -> dict:
    """Flatten a wrapper-BSDF chain (LoaderBSDF.cpp:82-151) into a material
    spec of <= 2 leaf lobes plus one normal modifier:

    * mix/blend(first, second, weight)    -> two lobes, mix_kind=1
    * add(first, second)                  -> two lobes, mix_kind=2
    * mask(bsdf, weight[, inverted])      -> mix(child, passthrough, weight)
      (MaskBSDF.cpp:36-55); cutoff adds the threshold select
    * bumpmap/normalmap/transform(bsdf)   -> leaf + normal modifier
      (bsdf/map.art make_bumpmap/make_normalmap/make_normal_set)
    * twosided/doublesided(bsdf)          -> inner bsdf (IgnoreBSDF.cpp)

    Chains that don't fit (mix of mixes, per-lobe modifiers) degrade with a
    warning: the dominant lobe / outermost modifier wins.
    """
    spec = dict(leaf_a=obj, leaf_b=None, mix_kind=0, mix_weight=0.5,
                mix_weight_tex=None, mix_cutoff=None, nmod_kind=0,
                nmod_strength=1.0, nmod_normal=np.float32([0, 0, 1]),
                nmod_tangent=None, nmod_tex=None)
    btype = obj.get("type", "diffuse")
    if btype not in _WRAPPER_TYPES or depth > 8:
        return spec

    import warnings

    def child(name):
        ref = obj.get(name, "")
        if isinstance(ref, dict):
            return ref          # inline nested bsdf object
        cobj = scene.bsdfs.get(ref) if isinstance(ref, str) else None
        if cobj is None:
            # ErrorBSDF semantics: signal-pink diffuse
            return {"type": "diffuse", "reflectance": [1, 0, 1]}
        return cobj

    def leaf_of(sub):
        """Collapse a sub-spec to one leaf, warning when lossy."""
        s = _flatten_bsdf(scene, sub, depth + 1)
        if s["leaf_b"] is not None:
            warnings.warn("nested two-lobe BSDF flattened to its dominant "
                          "lobe (unsupported nesting depth)")
            return s["leaf_a"] if s["mix_weight"] < 0.5 else s["leaf_b"]
        if s["nmod_kind"]:
            warnings.warn("normal modifier below a blend wrapper is ignored")
        return s["leaf_a"]

    if btype in ("twosided", "doublesided"):
        return _flatten_bsdf(scene, child("bsdf"), depth + 1)

    if btype in ("mix", "blend", "add"):
        spec["leaf_a"] = leaf_of(child("first"))
        spec["leaf_b"] = leaf_of(child("second"))
        if btype == "add":
            spec["mix_kind"] = 2
        else:
            spec["mix_kind"] = 1
            wv, wtex = _number(obj.get("weight"), 0.5)
            spec["mix_weight"] = wv
            if isinstance(wtex, str):
                spec["mix_weight_tex"] = wtex
        return spec

    if btype in ("mask", "cutoff"):
        inner = leaf_of(child("bsdf"))
        passthrough = {"type": "passthrough"}
        wv, wtex = _number(obj.get("weight"), 0.5)
        inverted = bool(obj.get("inverted", False))
        # mix(child, passthrough, weight) — inverted swaps the lobes
        spec["leaf_a"], spec["leaf_b"] = ((passthrough, inner) if inverted
                                          else (inner, passthrough))
        spec["mix_kind"] = 1
        spec["mix_weight"] = wv
        if isinstance(wtex, str):
            spec["mix_weight_tex"] = wtex
        if btype == "cutoff":
            cv, _ = _number(obj.get("cutoff"), 0.5)
            spec["mix_cutoff"] = cv
        return spec

    # normal modifiers wrap a single child chain
    sub = _flatten_bsdf(scene, child("bsdf"), depth + 1)
    spec.update({k: sub[k] for k in ("leaf_a", "leaf_b", "mix_kind",
                                     "mix_weight", "mix_weight_tex",
                                     "mix_cutoff")})
    if sub["nmod_kind"]:
        import warnings as _w
        _w.warn("stacked normal modifiers: outermost wins")
    sv, _ = _number(obj.get("strength"), 1.0)
    spec["nmod_strength"] = sv
    if btype == "normalmap":
        spec["nmod_kind"] = 1
        cv, ctex = _color(obj.get("map"), (0.5, 0.5, 1.0))
        spec["nmod_normal"] = cv
        if isinstance(ctex, str):
            spec["nmod_tex"] = ctex
    elif btype == "bumpmap":
        spec["nmod_kind"] = 2
        _, mtex = _number(obj.get("map"), 0.0)
        if isinstance(mtex, str):
            spec["nmod_tex"] = mtex
        elif isinstance(obj.get("map"), str):
            spec["nmod_tex"] = obj["map"]
    else:  # transform
        nraw = obj.get("normal")
        if isinstance(nraw, str):
            # PExpr-valued normal (the Cycles exporter emits
            # ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, ...)) here):
            # evaluate the full expression per lane at shading time with
            # the N/Nx/Ny/Ng/V context (Transpiler.cpp ctx bindings).
            # Discarding it for a constant (the pre-r5 behavior) flattened
            # every bump/normal expression to a +Z normal set — the
            # root cause of the cycles-bumpmap/normalmap structure miss.
            spec["nmod_kind"] = 4
            spec["nmod_tex"] = nraw
        else:
            spec["nmod_kind"] = 3
            nv, _ = _color(nraw, (0, 0, 1))
            spec["nmod_normal"] = nv
        if "tangent" in obj:
            tv, _ = _color(obj.get("tangent"), (1, 0, 0))
            spec["nmod_tangent"] = tv
    return spec


def compile_scene(scene: Scene, width: int | None = None, height: int | None = None) -> CompiledScene:
    film_size = scene.film.get("size", [800, 600])
    w = int(width or film_size[0])
    h = int(height or film_size[1])
    sampler = scene.film.get("sampler", "independent")

    # scene-wide parameters (docs/src/scene/pexpr.rst "Scene Parameters")
    global _PARAM_VALUES
    _PARAM_VALUES = {}
    params = scene.parameters
    plist = params if isinstance(params, list) else []
    for pdef in plist:
        pname = pdef.get("name")
        ptype = pdef.get("type", "number")
        pval = pdef.get("value", 0)
        if pname is None:
            continue
        kind = {"number": "num", "vector": "vec3", "color": "vec4"}.get(
            ptype, "num")
        if kind == "vec4" and isinstance(pval, list) and len(pval) == 3:
            pval = list(pval) + [1.0]
        _PARAM_VALUES[pname] = (kind, pval)
    scene_params = dict(_PARAM_VALUES)

    camera = _compile_camera(scene, w, h)
    technique = _compile_technique(scene)

    # ---- textures
    from ignis_tpu_torch.texture.loader import compile_textures
    textures, img_tables = compile_textures(scene)
    tex_index = {t["name"]: i for i, t in enumerate(textures)}

    from ignis_tpu_torch.texture.loader import TEX_EXPR

    def tex_of(name):
        """Texture id for a name; non-name strings become implicit PExpr
        textures (the ShadingTree transpiles such strings via PExpr —
        loader/ShadingTree.cpp addColor/addNumber string path)."""
        if name in tex_index:
            return tex_index[name]
        key = "__expr:" + name
        if key not in tex_index:
            tex_index[key] = len(textures)
            textures.append(dict(type=TEX_EXPR, name=key, expr=name, obj={}))
        return tex_index[key]

    # ---- materials (BSDFs): wrapper chains (mix/add/mask/cutoff/bumpmap/
    # normalmap/transform/twosided — LoaderBSDF.cpp:82-151) are flattened at
    # compile time into <= 2 leaf lobes + one normal modifier per material.
    bsdf_names = list(scene.bsdfs_order)
    bsdf_index = {n: i for i, n in enumerate(bsdf_names)}
    nmat = max(1, len(bsdf_names))
    mat_colors = np.zeros((nmat, 4, 3), dtype=np.float32)
    mat_scalars = np.zeros((nmat, 16), dtype=np.float32)
    mat_tex = np.full((nmat, 4), -1, dtype=np.int32)
    mat_colors_b = np.zeros((nmat, 4, 3), dtype=np.float32)
    mat_scalars_b = np.zeros((nmat, 16), dtype=np.float32)
    mat_tex_b = np.full((nmat, 4), -1, dtype=np.int32)
    # [weight, cutoff(-1 = plain mix), pad, pad]
    mat_wrap_f = np.zeros((nmat, 4), dtype=np.float32)
    mat_wrap_f[:, 1] = -1.0
    mat_wrap_tex = np.full((nmat,), -1, dtype=np.int32)
    # [strength, normal.xyz, tangent.xyz, has_tangent]
    mat_nmod_f = np.zeros((nmat, 8), dtype=np.float32)
    mat_nmod_tex = np.full((nmat,), -1, dtype=np.int32)
    bsdf_types = []
    bsdf_types_b = []    # -1 = single-lobe material
    mix_kinds = []       # 0 = single, 1 = mix, 2 = add
    nmod_kinds = []      # 0 = none, 1 = normalmap, 2 = bumpmap, 3 = normal-set
    flat_leaves_a = []
    for i, nname in enumerate(bsdf_names):
        spec = _flatten_bsdf(scene, scene.bsdfs[nname])
        flat_leaves_a.append(spec["leaf_a"])
        bsdf_types.append(_compile_bsdf(spec["leaf_a"], mat_colors[i],
                                        mat_scalars[i], mat_tex[i], tex_of))
        if spec["leaf_b"] is not None:
            bsdf_types_b.append(_compile_bsdf(
                spec["leaf_b"], mat_colors_b[i], mat_scalars_b[i],
                mat_tex_b[i], tex_of))
            mix_kinds.append(spec["mix_kind"])
            mat_wrap_f[i, 0] = spec["mix_weight"]
            if spec["mix_cutoff"] is not None:
                mat_wrap_f[i, 1] = spec["mix_cutoff"]
            if spec["mix_weight_tex"] is not None:
                mat_wrap_tex[i] = tex_of(spec["mix_weight_tex"])
        else:
            bsdf_types_b.append(-1)
            mix_kinds.append(0)
        nmod_kinds.append(spec["nmod_kind"])
        if spec["nmod_kind"]:
            mat_nmod_f[i, 0] = spec["nmod_strength"]
            mat_nmod_f[i, 1:4] = spec["nmod_normal"]
            if spec["nmod_tangent"] is not None:
                mat_nmod_f[i, 4:7] = spec["nmod_tangent"]
                mat_nmod_f[i, 7] = 1.0
            if spec["nmod_tex"] is not None:
                mat_nmod_tex[i] = tex_of(spec["nmod_tex"])
    if not bsdf_names:
        bsdf_types.append(BSDF_DIFFUSE)
        bsdf_types_b.append(-1)
        mix_kinds.append(0)
        nmod_kinds.append(0)
        mat_colors[0, 0] = 0.5

    # measured materials: per-material device tables + static info
    klems_info = {}
    tt_info = {}
    dj_info = {}
    klems_tables_all = {}
    for i, nname in enumerate(bsdf_names):
        if -1 != bsdf_types_b[i] and bsdf_types_b[i] in (
                BSDF_KLEMS, BSDF_TENSORTREE, BSDF_DJMEASURED):
            import warnings
            warnings.warn("measured BSDF as second blend lobe is "
                          "unsupported; degrading to diffuse")
            bsdf_types_b[i] = BSDF_DIFFUSE
            mat_colors_b[i, 0] = np.float32([1, 0, 1])
        if bsdf_types[i] == BSDF_DJMEASURED:
            obj = flat_leaves_a[i]
            from ignis_tpu_torch.measured.djmeasured import load_brdf
            from ignis_tpu_torch.utils.cache import cached_pickle
            try:
                tbl, info = cached_pickle(
                    scene.resolve_path(obj["filename"]), "djbrdf",
                    lambda p: load_brdf(p, f"dj{i}"), extra=f"dj{i}")
            except Exception as e:
                import warnings
                warnings.warn(f"Failed to load djmeasured "
                              f"'{obj.get('filename')}': {e}")
                bsdf_types[i] = BSDF_DIFFUSE
                mat_colors[i, 0] = np.float32([1, 0, 1])
                continue
            dj_info[i] = info
            klems_tables_all.update(tbl)
            continue
        if bsdf_types[i] == BSDF_TENSORTREE:
            obj = flat_leaves_a[i]
            from ignis_tpu_torch.measured.tensortree import (
                load_tensortree_xml, tensortree_tables)
            from ignis_tpu_torch.utils.cache import cached_pickle
            try:
                tbl, info = cached_pickle(
                    scene.resolve_path(obj["filename"]), "ttbsdf",
                    lambda p: tensortree_tables(load_tensortree_xml(p),
                                                f"tt{i}"),
                    extra=f"tt{i}")
            except Exception as e:
                import warnings
                warnings.warn(f"Failed to load tensortree "
                              f"'{obj.get('filename')}': {e}")
                bsdf_types[i] = BSDF_DIFFUSE
                mat_colors[i, 0] = np.float32([1, 0, 1])
                continue
            up = np.asarray(obj.get("up", [0, 0, 1]), np.float64)
            info["up"] = (up / max(np.linalg.norm(up), 1e-12)).astype(np.float32)
            tt_info[i] = info
            klems_tables_all.update(tbl)
            continue
        if bsdf_types[i] != BSDF_KLEMS:
            continue
        obj = flat_leaves_a[i]
        from ignis_tpu_torch.measured.klems import klems_tables, load_klems_xml
        from ignis_tpu_torch.utils.cache import cached_pickle
        try:
            tbl, info = cached_pickle(
                scene.resolve_path(obj["filename"]), "klems",
                lambda p: klems_tables(load_klems_xml(p), f"klems{i}"),
                extra=f"klems{i}")
        except Exception as e:
            import warnings
            warnings.warn(f"Failed to load klems '{obj.get('filename')}': {e};"
                          f" substituting error bsdf")
            bsdf_types[i] = BSDF_DIFFUSE
            mat_colors[i, 0] = np.float32([1, 0, 1])
            continue
        up = np.asarray(obj.get("up", [0, 0, 1]), np.float64)
        info["up"] = (up / max(np.linalg.norm(up), 1e-12)).astype(np.float32)
        klems_info[i] = info
        klems_tables_all.update(tbl)

    # ---- shapes
    shape_meshes: dict[str, TriMesh] = {}
    gltf_meshes = getattr(scene, "gltf_inline_meshes", {})
    for name in scene.shapes_order:
        sobj = scene.shapes[name]
        if sobj.get("type") == "gltf_inline" and name in gltf_meshes:
            pos, faces, nrm, uv = gltf_meshes[name]
            mesh = TriMesh(pos, faces.astype(np.int32), nrm, uv)
            mesh.ensure_normals()
            mesh.ensure_texcoords()
            shape_meshes[name] = mesh
        else:
            shape_meshes[name] = build_shape(sobj, scene.resolve_path)

    # ---- entities → world-space triangle soup, grouped per entity
    ent_names = list(scene.entities_order)
    num_entities = len(ent_names)
    ent_index = {n: i for i, n in enumerate(ent_names)}

    # Instancing split (SceneBVHAdapter.h:88-131 semantics, TPU redesign
    # in ops/bw_tlas.py): entities whose shape is reused by >= 2 eligible
    # entities keep ONE local copy of the mesh plus a per-instance
    # transform record instead of a world-space bake.  Emissive entities
    # (area-light targets) and media-interface entities stay baked so the
    # light/medium tables keep their world-space assumptions.
    light_entities = {str(scene.lights[ln].get("entity", ""))
                      for ln in scene.lights_order}
    shape_users: dict[str, list] = {}
    for ename in ent_names:
        eobj = scene.entities[ename]
        eligible = (ename not in light_entities
                    and not eobj.get("inner_medium")
                    and not eobj.get("outer_medium"))
        if eligible:
            shape_users.setdefault(eobj.get("shape"), []).append(ename)
    instanced_ents = {en for sname, users in shape_users.items()
                      if len(users) >= 2 for en in users}
    inst_shapes: list = []          # unique shape dicts for build_tlas
    inst_shape_idx: dict[str, int] = {}
    inst_records: list = []         # (shape_idx, toLocal, toWorld, nmat,
    #                                  ent, flags)
    inst_bbox_pts: list = []
    sph_list: list = []             # analytic spheres (ops/spheres.py)
    sph_ent_idx: dict[int, int] = {}
    tri_chunks = []
    ent_mat = np.zeros(max(1, num_entities), dtype=np.int32)
    ent_flags = np.full(max(1, num_entities), 0xF, dtype=np.int32)
    ent_tri_offset = np.zeros(max(1, num_entities), dtype=np.int32)
    ent_tri_count = np.zeros(max(1, num_entities), dtype=np.int32)
    ent_plane = {}   # entity id -> (origin, x_axis, y_axis, normal, area) if plane shape
    ent_local_mat = np.tile(np.eye(3, 4, dtype=np.float32),
                            (max(1, num_entities), 1, 1))
    ent_lbbox_min = np.zeros((max(1, num_entities), 3), np.float32)
    ent_lbbox_max = np.ones((max(1, num_entities), 3), np.float32)
    offset = 0
    for ei, ename in enumerate(ent_names):
        eobj = scene.entities[ename]
        sname = eobj.get("shape")
        if sname not in shape_meshes:
            raise SceneError(f"Entity '{ename}' references unknown shape '{sname}'")
        mesh = shape_meshes[sname]
        m4 = parse_transform(eobj.get("transform"))
        # world→local matrix + local shape bbox (for Np normalization,
        # pointmapper.art:4-7)
        inv = np.linalg.inv(m4)
        ent_local_mat[ei] = inv[:3, :].astype(np.float32)
        if mesh.vertices.size:
            ent_lbbox_min[ei] = mesh.vertices.min(axis=0)
            ent_lbbox_max[ei] = mesh.vertices.max(axis=0)

        flags = 0
        if eobj.get("camera_visible", True):
            flags |= 0x1
        if eobj.get("light_visible", True):
            flags |= 0x2
        if eobj.get("bounce_visible", True):
            flags |= 0x4
        if eobj.get("shadow_visible", True):
            flags |= 0x8
        ent_flags[ei] = flags
        bname = eobj.get("bsdf")
        ent_mat[ei] = bsdf_index.get(bname, 0)

        # ---- analytic sphere promotion (SphereProvider.cpp:1-71,
        # artic/shapes/sphere.art): "sphere" shapes under a uniform-scale
        # transform and no media interface become EXACT sphere records
        # (ops/spheres.py) instead of a tessellated bake — exact hits and
        # exact solid-angle light sampling (the three-planes family's
        # r=0.01 source was previously a blurred 512-tri uv-sphere).
        # the analytic sweep is a dense (rays, spheres) test — past a few
        # hundred spheres its memory/work beats tessellation+BVH, so
        # later spheres fall back to the mesh path
        asph = getattr(mesh, "analytic", None)
        if (asph is not None and asph[0] == "sphere"
                and len(sph_list) < 64
                and not eobj.get("inner_medium")
                and not eobj.get("outer_medium")):
            R3 = m4[:3, :3]
            s3 = np.linalg.norm(R3, axis=0)
            uniform = (np.allclose(s3, s3[0], rtol=1e-4)
                       and np.allclose((R3 / s3[0]).T @ (R3 / s3[0]),
                                       np.eye(3), atol=1e-4))
            if uniform:
                _, c_loc, r_loc = asph
                c_w = R3 @ np.asarray(c_loc, np.float64) + m4[:3, 3]
                r_w = float(r_loc * s3[0])
                rot_wl = (R3 / s3[0]).T   # world->local rotation (UV)
                sph_ent_idx[ei] = len(sph_list)
                sph_list.append((c_w.astype(np.float32), np.float32(r_w),
                                 ei, flags, rot_wl.astype(np.float32)))
                inst_bbox_pts.append((c_w - r_w).astype(np.float32))
                inst_bbox_pts.append((c_w + r_w).astype(np.float32))
                ent_tri_offset[ei] = offset
                ent_tri_count[ei] = 0
                continue

        if ename in instanced_ents and mesh.face_count > 0:
            if sname not in inst_shape_idx:
                mesh.ensure_normals()
                mesh.ensure_texcoords()
                iv = mesh.indices
                lv0 = mesh.vertices[iv[:, 0]]
                lv1 = mesh.vertices[iv[:, 1]]
                lv2 = mesh.vertices[iv[:, 2]]
                inst_shape_idx[sname] = len(inst_shapes)
                inst_shapes.append(dict(
                    v0=lv0, e1=lv1 - lv0, e2=lv2 - lv0,
                    n0=mesh.normals[iv[:, 0]],
                    n1=mesh.normals[iv[:, 1]],
                    n2=mesh.normals[iv[:, 2]],
                    uv0=mesh.texcoords[iv[:, 0]],
                    uv1=mesh.texcoords[iv[:, 1]],
                    uv2=mesh.texcoords[iv[:, 2]]))
            nmat = np.linalg.inv(m4[:3, :3]).T
            inst_records.append((inst_shape_idx[sname],
                                 inv[:3, :].astype(np.float32),
                                 m4[:3, :].astype(np.float32),
                                 nmat.astype(np.float32), ei, flags))
            corners = mesh.vertices @ m4[:3, :3].T + m4[:3, 3]
            inst_bbox_pts.append(corners.min(axis=0))
            inst_bbox_pts.append(corners.max(axis=0))
            ent_tri_offset[ei] = offset
            ent_tri_count[ei] = 0
            continue

        world = mesh.transformed(m4)
        v0 = world.vertices[world.indices[:, 0]]
        v1 = world.vertices[world.indices[:, 1]]
        v2 = world.vertices[world.indices[:, 2]]
        n0 = world.normals[world.indices[:, 0]]
        n1 = world.normals[world.indices[:, 1]]
        n2 = world.normals[world.indices[:, 2]]
        t0 = world.texcoords[world.indices[:, 0]]
        t1 = world.texcoords[world.indices[:, 1]]
        t2 = world.texcoords[world.indices[:, 2]]
        f = world.face_count
        tri_chunks.append((v0, v1 - v0, v2 - v0, n0, n1, n2, t0, t1, t2,
                           np.full(f, ei, dtype=np.int32),
                           np.arange(f, dtype=np.int32)))
        # (visibility flags per LoaderEntity.cpp:123-131 and material
        # binding were resolved before the instancing split above)
        ent_tri_offset[ei] = offset
        ent_tri_count[ei] = f
        offset += f
        plane = _detect_plane(world)
        if plane is not None:
            ent_plane[ei] = plane

    if tri_chunks:
        cat = [np.concatenate([c[k] for c in tri_chunks]) for k in range(11)]
    else:
        cat = [np.zeros((0, 3), np.float32)] * 6 + [np.zeros((0, 2), np.float32)] * 3 \
            + [np.zeros((0,), np.int32)] * 2
    (tri_v0, tri_e1, tri_e2, tri_n0, tri_n1, tri_n2,
     tri_uv0, tri_uv1, tri_uv2, tri_ent, tri_prim) = cat

    if tri_v0.shape[0] == 0:
        # geometry-less scene (e.g. environment-only): keep one degenerate
        # triangle so device gathers stay well-formed; it can never be hit.
        z3 = np.zeros((1, 3), np.float32)
        z2 = np.zeros((1, 2), np.float32)
        tri_v0, tri_e1, tri_e2 = z3, z3.copy(), z3.copy()
        tri_n0 = tri_n1 = tri_n2 = np.tile(np.float32([0, 0, 1]), (1, 1))
        tri_uv0, tri_uv1, tri_uv2 = z2, z2.copy(), z2.copy()
        tri_ent = np.zeros(1, np.int32)
        tri_prim = np.zeros(1, np.int32)

    bpts = []
    if tri_v0.shape[0] > 0:
        pts = np.concatenate([tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2])
        bpts += [pts.min(axis=0), pts.max(axis=0)]
    bpts += inst_bbox_pts
    if bpts:
        bbox_min = np.min(np.stack(bpts), axis=0).astype(np.float32)
        bbox_max = np.max(np.stack(bpts), axis=0).astype(np.float32)
    else:
        bbox_min = np.zeros(3, np.float32)
        bbox_max = np.zeros(3, np.float32)

    # Default camera auto-framing over the scene bbox
    # (PerspectiveCamera.cpp:70-103)
    if getattr(camera, "auto_frame", False) and tri_v0.shape[0] > 0:
        diam = bbox_max - bbox_min
        a = diam[0] / (2 * (camera.aspect if camera.fov_vertical else 1.0))
        b = diam[1] / (2 * (camera.aspect if not camera.fov_vertical else 1.0))
        sn = math.sin(camera.fov / 2)
        dist = 0.0 if abs(sn) <= 1e-7 else max(a, b) * math.sqrt(
            max(1.0 / (sn * sn) - 1.0, 0.0))
        center = (bbox_max + bbox_min) * 0.5
        camera.eye = np.asarray([center[0], center[1],
                                 bbox_max[2] + dist], np.float32)
        camera.dir = np.asarray([0, 0, -1], np.float32)
        camera.up = np.asarray([0, 1, 0], np.float32)

    # ---- media (LoaderMedium.cpp: homogeneous/constant, heterogeneous,
    #      vacuum; HeterogeneousMedium.cpp for the grid/shader properties)
    media: list[dict] = []
    media_index: dict[str, int] = {}
    medium_tables: dict[str, np.ndarray] = {}
    nmed = max(1, len(scene.media_order))
    medium_data = np.zeros((nmed, 8), dtype=np.float32)
    from ignis_tpu_torch.medium.volume import SHADER_ROW, shader_row_from_props
    medium_shader = np.zeros((nmed, SHADER_ROW), dtype=np.float32)
    medium_majorant = np.zeros((nmed, 3), dtype=np.float32)
    for mi, mname in enumerate(scene.media_order):
        mobj = scene.media[mname]
        mtype = mobj.get("type", "homogeneous")
        rec = dict(name=mname, type=mtype,
                   sigma_a_expr=None, sigma_s_expr=None,
                   max_scattering=int(mobj.get("max_scattering", 8)))
        if mtype in ("constant", "homogeneous"):
            sa = mobj.get("sigma_a", [0, 0, 0])
            ss = mobj.get("sigma_s", [0, 0, 0])
            if isinstance(sa, str):
                rec["sigma_a_expr"] = sa
            else:
                medium_data[mi, 0:3], _ = _color(sa, (0, 0, 0))
            if isinstance(ss, str):
                rec["sigma_s_expr"] = ss
            else:
                medium_data[mi, 3:6], _ = _color(ss, (0, 0, 0))
            medium_data[mi, 6], _ = _number(mobj.get("g"), 0.0)
        elif mtype == "heterogeneous":
            fn = mobj.get("filename")
            if fn is None:
                raise ValueError(f"Heterogeneous medium '{mname}' needs a "
                                 "filename")
            path = scene.resolve_path(fn)
            medium_data[mi, 6], _ = _number(mobj.get("g"), 0.0)
            row = shader_row_from_props(mobj)
            medium_shader[mi] = row
            rec["interpolate"] = bool(mobj.get("interpolate", False))
            rec["method"] = mobj.get("method", "regular")
            rec["reference"] = mobj.get("reference")  # entity name or None
            ext = str(path).rsplit(".", 1)[-1].lower()
            if ext == "bin":
                from ignis_tpu_torch.medium.volume import load_voxel_grid_bin
                grid = load_voxel_grid_bin(path)
                rec["type"] = "hetero_voxel"
                # .bin grids default scalar_emission to 1 instead of 0
                # (HeterogeneousMedium.cpp:206 vs :121)
                if "scalar_emission" not in mobj:
                    row[1] = 1.0
                    medium_shader[mi] = row
                # simple_volume shader folds scalar_density×scalar_* into
                # the colors (HeterogeneousMedium.cpp:203-216)
                css = row[2:5] * row[0] * row[18]
                csa = row[5:8] * row[0] * row[17]
                medium_tables[f"vol{mi}_sigma_s"] = grid["sigma_s"]
                medium_tables[f"vol{mi}_sigma_a"] = grid["sigma_a"]
                medium_tables[f"vol{mi}_emission"] = grid["emission"]
                ext_max = (grid["sigma_s"] * css
                           + grid["sigma_a"] * csa).reshape(-1, 3)
                medium_majorant[mi] = (ext_max.max(axis=0)
                                       if ext_max.size else 0.0)
            elif ext == "nvdb":
                from ignis_tpu_torch.medium.nanovdb import load_nvdb_grid
                gname = mobj.get("grid_density", "density")
                tname = mobj.get("grid_temperature", "none")
                dens = load_nvdb_grid(path, gname)
                rec["type"] = "hetero_density"
                rec["shader"] = mobj.get("shader", "monochromatic")
                medium_tables[f"vol{mi}_density"] = dens
                rec["has_temperature"] = tname != "none"
                if tname != "none":
                    medium_tables[f"vol{mi}_temperature"] = \
                        load_nvdb_grid(path, tname)
                # conservative majorant from max density through the shader
                dmax = np.asarray([float(dens.max())] if dens.size else [0.0],
                                  np.float32)
                tmax = None
                if tname != "none":
                    t_ = medium_tables[f"vol{mi}_temperature"]
                    tmax = np.asarray([float(t_.max())], np.float32)
                from ignis_tpu_torch.medium.volume import apply_density_shader
                mss, msa, _ = apply_density_shader(rec["shader"], row,
                                                   dmax, tmax)
                medium_majorant[mi] = np.asarray(mss + msa)[0]
            else:
                raise ValueError(f"Heterogeneous medium file extension "
                                 f".{ext} not supported")
        elif mtype == "vacuum":
            rec["type"] = "vacuum"
        else:
            import warnings
            warnings.warn(f"Medium type '{mtype}' not supported yet; "
                          f"treating '{mname}' as vacuum")
            rec["type"] = "vacuum"
        media.append(rec)
        media_index[mname] = mi

    ent_inner_medium = np.full(max(1, num_entities), -1, dtype=np.int32)
    ent_outer_medium = np.full(max(1, num_entities), -1, dtype=np.int32)
    for ei, ename in enumerate(ent_names):
        eobj = scene.entities[ename]
        ent_inner_medium[ei] = media_index.get(eobj.get("inner_medium", ""), -1)
        ent_outer_medium[ei] = media_index.get(eobj.get("outer_medium", ""), -1)

    # Reference entity per medium: explicit `reference` property, else the
    # first entity using the medium as inner (LoaderMedium.cpp:61-73)
    ent_index = {en: i for i, en in enumerate(ent_names)}
    for mi, rec in enumerate(media):
        if not rec["type"].startswith("hetero"):
            continue
        ref = rec.get("reference")
        if ref is not None and ref in ent_index:
            rec["ref_entity"] = ent_index[ref]
        else:
            users = np.nonzero(ent_inner_medium == mi)[0]
            rec["ref_entity"] = int(users[0]) if users.size else 0

    # ---- lights
    lights: list[LightInfo] = []
    light_f = []  # generic per-light float rows
    light_extra = {}  # per-light named tables (env CDFs, ...)
    ent_light = np.full(max(1, num_entities), -1, dtype=np.int32)

    def lrow(*vals):
        row = np.zeros(32, dtype=np.float32)
        flat = []
        for v in vals:
            flat.extend(np.asarray(v, dtype=np.float32).reshape(-1))
        row[:len(flat)] = flat
        return row

    for lname in scene.lights_order:
        lobj = scene.lights[lname]
        ltype = lobj.get("type", "point")
        # alias spellings accepted by the reference (LoaderLight.cpp:57-96)
        ltype = {"cieuniform": "cie_uniform", "ciecloudy": "cie_cloudy",
                 "cieclear": "cie_clear",
                 "cieintermediate": "cie_intermediate"}.get(ltype, ltype)
        lid = len(lights)
        if ltype == "point":
            pos, _ = _color(lobj.get("position"), (0, 0, 0))
            if "power" in lobj:
                inten, _ = _color(lobj.get("power"), (4 * math.pi,) * 3)
                inten = inten / (4 * math.pi)
            else:
                inten, _ = _color(lobj.get("intensity"), (1, 1, 1))
            lights.append(LightInfo(LIGHT_POINT, lname, False, True, draws=0))
            light_f.append(lrow(pos, inten))
        elif ltype == "area":
            ent = ent_index.get(lobj.get("entity", ""))
            if ent is None:
                raise SceneError(f"Area light '{lname}' references unknown entity")
            o_, c_ = int(ent_tri_offset[ent]), int(ent_tri_count[ent])
            if ent in sph_ent_idx:
                ent_area = 4.0 * math.pi * float(sph_list[sph_ent_idx[ent]][1]) ** 2
            else:
                ent_area = float(0.5 * np.linalg.norm(
                    np.cross(tri_e1[o_:o_ + c_], tri_e2[o_:o_ + c_]),
                    axis=-1).sum()) if c_ else 1.0
            if "power" in lobj:
                # AreaLight.cpp:101-105: radiance = power / (pi * area)
                pw, _tex = _color(lobj.get("power"), (1, 1, 1))
                rad = pw / max(math.pi * ent_area, 1e-9)
            else:
                rad, _tex = _color(lobj.get("radiance"), (1, 1, 1))
            scale, _ = _color(lobj.get("scale"), (1, 1, 1))
            rad = rad * scale
            ent_light[ent] = lid
            if ent in sph_ent_idx:
                # analytic sphere emitter (light/area.art:241-297):
                # equal-area sampling of the VISIBLE half, pdf 2/area
                cw, rw, _, _, _ = sph_list[sph_ent_idx[ent]]
                lights.append(LightInfo(LIGHT_AREA_SPHERE, lname, False,
                                        False, entity=ent, draws=2))
                # radiance FIRST so _area_light_radiance's default
                # (data[0:3]) covers sphere emitters like mesh ones
                light_f.append(lrow(rad, [rw], cw, [float(ent)],
                                    [ent_area]))
            elif ent in ent_plane and lobj.get("optimize", True):
                origin, xa, ya, nrm, area = ent_plane[ent]
                lights.append(LightInfo(LIGHT_AREA_PLANE, lname, False, False,
                                        entity=ent, draws=2))
                light_f.append(lrow(origin, xa, ya, nrm, [area], rad))
            else:
                lights.append(LightInfo(
                    LIGHT_AREA_MESH, lname, False, False, entity=ent,
                    tri_offset=int(ent_tri_offset[ent]),
                    tri_count=int(ent_tri_count[ent]), draws=2))
                light_f.append(lrow(rad, [float(ent_tri_offset[ent])],
                                    [float(ent_tri_count[ent])], [float(ent)]))
        elif ltype in ("env", "envmap", "constant"):
            rad, tex = _color(lobj.get("radiance"), (1, 1, 1))
            scale, _ = _color(lobj.get("scale"), (1, 1, 1))
            tr = parse_transform(lobj.get("transform")) if "transform" in lobj else np.eye(4)
            trans = np.linalg.inv(tr[:3, :3]).T  # as in EnvironmentLight.cpp:45
            tid = tex_of(tex) if isinstance(tex, str) else -1
            use_cdf = bool(lobj.get("cdf", True))
            if tid >= 0 and use_cdf:
                # bake + 2D CDF (EnvironmentLight.cpp:47-66); the SAT
                # variant (cdf_method: "sat", EnvironmentLight.cpp:15,
                # CDF.cpp:135 computeForImageSAT) builds the summed-area
                # table with the reference's exact weighting (sin applied
                # to the FULL cell weight, not just the marginal) and
                # derives the sampling tables from it
                from ignis_tpu_torch.light.env_cdf import (
                    build_cdf2d, build_sat2d, sat_to_cdf,
                )
                img = _bake_texture(textures, img_tables, tid)
                comp = bool(lobj.get("compensate", True))
                if str(lobj.get("cdf_method", "")).lower() == "sat":
                    sat = build_sat2d(img, premultiply_sin=True,
                                      compensate=comp)
                    light_extra[f"light{lid}_sat"] = sat
                    m, c = sat_to_cdf(sat)
                else:
                    m, c = build_cdf2d(img, premultiply_sin=True,
                                       compensate=comp)
                light_extra[f"light{lid}_cdf_m"] = m
                light_extra[f"light{lid}_cdf_c"] = c
                lights.append(LightInfo(LIGHT_ENV_CDF, lname, True, False,
                                        draws=2, tex=tid))
            else:
                lights.append(LightInfo(LIGHT_ENV, lname, True, False,
                                        draws=2, tex=tid))
            light_f.append(lrow(scale if tid >= 0 else rad * scale,
                                trans.reshape(-1)))
        elif ltype in ("directional", "distant"):
            d, _ = _color(lobj.get("direction"), (0, 0, 1))
            nd = np.asarray(d) / max(np.linalg.norm(d), 1e-20)
            irr, _ = _color(lobj.get("irradiance"), (1, 1, 1))
            lights.append(LightInfo(LIGHT_DIRECTIONAL, lname, True, True, draws=0))
            light_f.append(lrow(nd, irr))
        elif ltype == "spot":
            pos, _ = _color(lobj.get("position"), (0, 0, 0))
            d, _ = _color(lobj.get("direction"), (0, 0, 1))
            nd = np.asarray(d) / max(np.linalg.norm(d), 1e-20)
            cutoff_v, _ = _number(lobj.get("cutoff"), 30.0)
            falloff_v, _ = _number(lobj.get("falloff"), 20.0)
            cutoff = cutoff_v * DEG2RAD
            falloff = falloff_v * DEG2RAD
            if "power" in lobj:
                # SpotLight.cpp:17-27: intensity = power / (2pi(1 - (cosC+cosF)/2))
                pw, _ = _color(lobj.get("power"), (1, 1, 1))
                inten = pw / max(2.0 * math.pi * (
                    1.0 - 0.5 * (math.cos(cutoff) + math.cos(falloff))), 1e-9)
            else:
                inten, _ = _color(lobj.get("intensity"), (1, 1, 1))
            lights.append(LightInfo(LIGHT_SPOT, lname, False, True, draws=0))
            light_f.append(lrow(pos, nd, inten,
                                [math.cos(cutoff), math.cos(falloff)]))
        elif ltype == "sun":
            d = _sun_direction(lobj)
            irr, _ = _color(lobj.get("irradiance"), (1, 1, 1))
            if "radius" in lobj:
                r, _ = _number(lobj.get("radius"), 1.0)
                cos_angle = 1.0 / math.sqrt(r * r + 1.0)
            else:
                ang, _ = _number(lobj.get("angle"), 11.4)
                cos_angle = math.cos(math.radians(ang) / 2.0)
            lights.append(LightInfo(LIGHT_SUN, lname, True, True, draws=2))
            light_f.append(lrow(d, irr, [0.0, 0.0, 0.0], [cos_angle]))
        elif ltype in ("cie_uniform", "cie_cloudy"):
            zen, _ = _color(lobj.get("zenith"), (1, 1, 1))
            scale, _ = _color(lobj.get("scale"), (1, 1, 1))
            grd, _ = _color(lobj.get("ground"), (1, 1, 1))
            gb, _ = _number(lobj.get("ground_brightness"), 0.2)
            has_ground = bool(lobj.get("has_ground", True))
            tr = parse_transform(lobj.get("transform")) if "transform" in lobj else np.eye(4)
            trans = np.linalg.inv(tr[:3, :3]).T
            li = LightInfo(LIGHT_ENV, lname, True, False, draws=2)
            li.sky = dict(kind=ltype, has_ground=has_ground,
                          hemi=not has_ground)
            lights.append(li)
            light_f.append(lrow(zen * scale, trans.reshape(-1), grd, [gb]))
        elif ltype in ("cie_clear", "cie_intermediate"):
            # CIELight.cpp:66-113 (sunny classifications)
            from ignis_tpu_torch.light import skysun
            zen, _ = _color(lobj.get("zenith"), (1, 1, 1))
            scale, _ = _color(lobj.get("scale"), (1, 1, 1))
            grd, _ = _color(lobj.get("ground"), (1, 1, 1))
            gb, _ = _number(lobj.get("ground_brightness"), 0.2)
            turb, _ = _number(lobj.get("turbidity"), 2.45)
            has_ground = bool(lobj.get("has_ground", True))
            el, az = skysun.get_ea(lobj)
            el = min(el, 87 * DEG2RAD)
            sun_dir = skysun.ea_to_dir(el, az)
            is_clear = ltype == "cie_clear"
            zb_over_f, c2 = skysun.cie_sunny_params(
                is_clear, not is_clear, el, float(sun_dir[1]), turb)
            tr = parse_transform(lobj.get("transform")) if "transform" in lobj else np.eye(4)
            trans = np.linalg.inv(tr[:3, :3]).T
            li = LightInfo(LIGHT_ENV, lname, True, False, draws=2)
            li.sky = dict(kind="cie_sunny", is_clear=is_clear,
                          has_ground=has_ground, hemi=not has_ground,
                          sun_dir=tuple(float(x) for x in sun_dir))
            lights.append(li)
            light_f.append(lrow(np.asarray(scale) * np.asarray(zen)
                                * zb_over_f, trans.reshape(-1),
                                np.asarray(scale) * np.asarray(grd) * gb * c2))
        elif ltype == "perez":
            # PerezLight.cpp:60-117 + light/cie.art:49-57
            from ignis_tpu_torch.light import skysun
            sun_dir = skysun.get_sun_direction(lobj)
            tp = skysun.get_timepoint(lobj)
            sin_elev = min(1.0, max(-1.0, -float(sun_dir[1])))
            solar_zenith = math.acos(min(1.0, max(-1.0, float(sun_dir[1]))))
            (pa, pb, pc, pd, pe), diff_irrad = skysun.perez_model_from_obj(
                lobj, solar_zenith, tp)
            diffnorm = diff_irrad / max(
                skysun.perez_integrate(pa, pb, pc, pd, pe, solar_zenith),
                1e-20)
            grd, _ = _color(lobj.get("ground"), (1, 1, 1))
            has_ground = bool(lobj.get("has_ground", True))
            if "luminance" in lobj:
                lum, _ = _color(lobj.get("luminance"), (1, 1, 1))
                lum = np.asarray(lum) * diffnorm
            else:
                lum, _ = _color(lobj.get("zenith"), (1, 1, 1))
                lum = np.asarray(lum) * float(
                    skysun.perez_eval(pa, pb, pc, pd, pe, sin_elev, 1.0)
                    * diffnorm)
            tr = parse_transform(lobj.get("transform")) if "transform" in lobj else np.eye(4)
            trans = np.linalg.inv(tr[:3, :3]).T
            li = LightInfo(LIGHT_ENV, lname, True, False, draws=2)
            li.sky = dict(kind="perez", has_ground=has_ground, hemi=False,
                          sun_dir=tuple(float(x) for x in sun_dir),
                          abcde=(pa, pb, pc, pd, pe))
            lights.append(li)
            light_f.append(lrow(lum, trans.reshape(-1), grd))
        elif ltype == "sky":
            # Hosek-Wilkie sky baked to an env texture + CDF
            # (SkyLight.cpp:30-75; SkyModel.cpp:9-55)
            from ignis_tpu_torch.light import skysun
            from ignis_tpu_torch.light.env_cdf import build_cdf2d
            from ignis_tpu_torch.light.hosek import bake_sky_image
            from ignis_tpu_torch.texture.loader import (FILTER_BILINEAR, TEX_IMAGE,
                                                  WRAP_REPEAT)
            scale, _ = _color(lobj.get("scale"), (1, 1, 1))
            grd, _ = _color(lobj.get("ground"), (0.8, 0.8, 0.8))
            turb, _ = _number(lobj.get("turbidity"), 3.0)
            el, az = skysun.get_ea(lobj)
            img = bake_sky_image(np.asarray(grd, np.float64), el, az, turb)
            key = f"light{lid}_sky_img"
            img_tables[key] = img
            tid = len(textures)
            textures.append(dict(
                type=TEX_IMAGE, name=f"__sky_{lname}", img_key=key,
                filter=FILTER_BILINEAR, wrap_u=WRAP_REPEAT,
                wrap_v=WRAP_REPEAT,
                transform=np.eye(4)[:2, (0, 1, 3)].astype(np.float32),
                linear=False))
            m, c = build_cdf2d(img, premultiply_sin=True, compensate=False)
            light_extra[f"light{lid}_cdf_m"] = m
            light_extra[f"light{lid}_cdf_c"] = c
            tr = parse_transform(lobj.get("transform")) if "transform" in lobj else np.eye(4)
            trans = np.linalg.inv(tr[:3, :3]).T
            lights.append(LightInfo(LIGHT_ENV_CDF, lname, True, False,
                                    draws=2, tex=tid))
            light_f.append(lrow(scale, trans.reshape(-1)))
        else:
            # Degrade gracefully like the reference loader (logs an error and
            # continues; LoaderLight.cpp unknown-plugin path).
            import warnings
            warnings.warn(f"Ignoring unsupported light type '{ltype}' "
                          f"(light '{lname}')")
            continue

    light_data = (np.stack(light_f) if light_f
                  else np.zeros((0, 32), dtype=np.float32))

    # ---- light selection tables (LoaderLight.cpp:423-473)
    # Selection probabilities are static per light; precompute both the
    # finite-light CDF (flux-weighted, "simple"/"hierarchy" selectors) and the
    # per-light selection pdf used by MIS.
    n_l = len(lights)
    sel_kind = technique.light_selector
    flux = np.ones(max(1, n_l), np.float32)
    scene_r = max(float(np.linalg.norm(bbox_max - bbox_min) * 0.5), 1e-3)
    for li, linfo in enumerate(lights):
        dataf = light_data[li]
        if linfo.type == LIGHT_POINT:
            flux[li] = float(dataf[3:6].mean()) * 4 * math.pi
        elif linfo.type == LIGHT_SPOT:
            flux[li] = float(dataf[6:9].mean()) * 2 * math.pi * max(
                1 - 0.5 * (dataf[9] + dataf[10]), 1e-3)
        elif linfo.type == LIGHT_AREA_PLANE:
            flux[li] = float(dataf[13:16].mean()) * float(dataf[12]) * math.pi
        elif linfo.type == LIGHT_AREA_MESH:
            flux[li] = float(dataf[0:3].mean()) * math.pi
        elif linfo.type == LIGHT_AREA_SPHERE:
            flux[li] = float(dataf[0:3].mean()) * float(dataf[8]) * math.pi
        elif linfo.type in (LIGHT_ENV, LIGHT_ENV_CDF):
            flux[li] = float(dataf[0:3].mean()) * math.pi * scene_r * scene_r
        elif linfo.type == LIGHT_DIRECTIONAL:
            flux[li] = float(dataf[3:6].mean()) * math.pi * scene_r * scene_r
        flux[li] = max(flux[li], 1e-8)

    finite_ids = [i for i, l in enumerate(lights) if not l.infinite]
    inf_ids_all = [i for i, l in enumerate(lights) if l.infinite]
    sel_pdf = np.full(max(1, n_l), 1.0, np.float32)
    fin_cdf = np.ones(max(1, len(finite_ids)), np.float32)
    if n_l > 1 and sel_kind in ("simple", "cdf", "hierarchy") and finite_ids:
        fw = flux[finite_ids]
        cdf = np.cumsum(fw / fw.sum()).astype(np.float32)
        cdf[-1] = 1.0
        fin_cdf = cdf
        pdf_fin = (fw / fw.sum()).astype(np.float32)
        if inf_ids_all:
            ratio = 0.5
            for k, li in enumerate(finite_ids):
                sel_pdf[li] = pdf_fin[k] * (1 - ratio)
            for li in inf_ids_all:
                sel_pdf[li] = ratio / len(inf_ids_all)
        else:
            for k, li in enumerate(finite_ids):
                sel_pdf[li] = pdf_fin[k]
    elif n_l > 0:
        sel_pdf[:n_l] = 1.0 / n_l
    # ---- light hierarchy selector tables (LightHierarchy.cpp:29-125)
    lh_tables: dict = {}
    lh_depth = 0
    fin_local = np.full(max(1, n_l), -1, np.int32)
    for k, li in enumerate(finite_ids):
        fin_local[li] = k
    if sel_kind == "hierarchy" and len(finite_ids) >= 2:
        from ignis_tpu_torch.light.hierarchy import build_light_hierarchy
        hpos, hdir, hhas = [], [], []
        scene_c = (bbox_min + bbox_max) * 0.5
        for li in finite_ids:
            t = lights[li].type
            dataf = light_data[li]
            if t == LIGHT_POINT:
                p, dd, hd = dataf[0:3], (0, 0, 1), False
            elif t == LIGHT_SPOT:
                p, dd, hd = dataf[0:3], dataf[3:6], True
            elif t == LIGHT_AREA_PLANE:
                p = dataf[0:3] + 0.5 * (dataf[3:6] + dataf[6:9])
                dd, hd = dataf[9:12], True
            elif t == LIGHT_AREA_MESH:
                o, c = lights[li].tri_offset, lights[li].tri_count
                cent = (tri_v0[o:o + c]
                        + (tri_e1[o:o + c] + tri_e2[o:o + c]) / 3.0)
                p = cent.mean(axis=0) if c else scene_c
                dd, hd = (0, 0, 1), False
            elif t == LIGHT_AREA_SPHERE:
                p, dd, hd = dataf[4:7], (0, 0, 1), False
            else:
                p, dd, hd = scene_c, (0, 0, 1), False
            hpos.append(np.asarray(p, np.float32))
            hdir.append(np.asarray(dd, np.float32))
            hhas.append(hd)
        lh_tables, lh_depth = build_light_hierarchy(
            hpos, hdir, hhas, flux[finite_ids])

    light_type_arr = np.asarray([l.type for l in lights] or [0], dtype=np.int32)
    light_inf_arr = np.asarray([l.infinite for l in lights] or [False], dtype=bool)
    light_delta_arr = np.asarray([l.delta for l in lights] or [False], dtype=bool)

    halton_setup = None
    if sampler == "halton":
        from ignis_tpu_torch.render.sampler import build_halton_offsets
        halton_setup = build_halton_offsets(w, h)

    tables = {
        "tri_v0": tri_v0.astype(np.float32), "tri_e1": tri_e1.astype(np.float32),
        "tri_e2": tri_e2.astype(np.float32),
        "tri_n0": tri_n0.astype(np.float32), "tri_n1": tri_n1.astype(np.float32),
        "tri_n2": tri_n2.astype(np.float32),
        "tri_uv0": tri_uv0.astype(np.float32), "tri_uv1": tri_uv1.astype(np.float32),
        "tri_uv2": tri_uv2.astype(np.float32),
        "tri_ent": tri_ent, "tri_prim": tri_prim,
        "ent_mat": ent_mat, "ent_light": ent_light, "ent_flags": ent_flags,
        "ent_local_mat": ent_local_mat,
        "ent_lbbox_min": ent_lbbox_min, "ent_lbbox_max": ent_lbbox_max,
        "ent_inner_medium": ent_inner_medium,
        "ent_outer_medium": ent_outer_medium,
        "medium_data": medium_data,
        "medium_shader": medium_shader,
        "medium_majorant": medium_majorant,
        **medium_tables,
        "ent_tri_offset": ent_tri_offset, "ent_tri_count": ent_tri_count,
        "mat_colors": mat_colors, "mat_scalars": mat_scalars,
        "mat_tex": mat_tex,
        "mat_colors_b": mat_colors_b, "mat_scalars_b": mat_scalars_b,
        "mat_tex_b": mat_tex_b,
        "mat_wrap_f": mat_wrap_f, "mat_wrap_tex": mat_wrap_tex,
        "mat_nmod_f": mat_nmod_f, "mat_nmod_tex": mat_nmod_tex,
        "mat_mix_kind": np.asarray(mix_kinds, np.int32),
        "mat_nmod_kind": np.asarray(nmod_kinds, np.int32),
        "light_data": light_data,
        **img_tables,
        "light_type": light_type_arr, "light_infinite": light_inf_arr,
        "light_delta": light_delta_arr,
        "light_sel_pdf": sel_pdf, "light_sel_cdf": fin_cdf,
        "light_fin_local": fin_local,
        **lh_tables,
    }
    if halton_setup is not None:
        tables["halton_offsets"] = halton_setup.pop("offsets")
    if sph_list:
        sph_rows = np.zeros((len(sph_list), 16), np.float32)
        for si, (cw, rw, ei, fl, rot) in enumerate(sph_list):
            sph_rows[si, 0:3] = cw
            sph_rows[si, 3] = rw
            sph_rows[si, 4] = np.float32(ei)
            sph_rows[si, 5] = np.float32(fl)
            sph_rows[si, 6:15] = rot.reshape(9)
        tables["sph_rows"] = sph_rows
    tables.update(light_extra)
    tables.update(klems_tables_all)

    # ---- parameter registry (ParameterSet, RuntimeStructs.h:56-69;
    # Runtime.cpp:668-731 built-in keys).  Scene `parameters` + built-ins
    # become ONE traced float vector so values can be changed (and
    # differentiated) between steps without recompilation.
    param_registry: dict = {}
    param_init: list = []

    def _reg_param(pn, kind, vals):
        size = {"num": 1, "int": 1, "vec2": 2, "vec3": 3, "vec4": 4}[kind]
        v = np.asarray(vals, np.float32).reshape(-1)
        if v.size == 1 and size > 1:
            v = np.full(size, v[0], np.float32)
        v = v[:size]
        if v.size < size:
            v = np.concatenate([v, np.ones(size - v.size, np.float32)])
        param_registry[pn] = (kind, len(param_init), size)
        param_init.extend(float(x) for x in v)

    for pname_, (pkind_, pval_) in scene_params.items():
        _reg_param(pname_, pkind_, pval_)
    _reg_param("__camera_eye", "vec3", camera.eye)
    _reg_param("__camera_dir", "vec3", camera.dir)
    _reg_param("__camera_up", "vec3", camera.up)
    _reg_param("__time", "num", 0.0)
    _reg_param("__scene_bbox_min", "vec3", bbox_min)
    _reg_param("__scene_bbox_max", "vec3", bbox_max)
    tables["params"] = np.asarray(param_init, np.float32)

    cs = CompiledScene(
        width=w, height=h, sampler=sampler, camera=camera, technique=technique,
        bsdf_types=bsdf_types, lights=lights, num_entities=num_entities,
        tables=tables, bbox_min=bbox_min, bbox_max=bbox_max,
        entity_names=ent_names, material_names=bsdf_names,
        textures=textures, media=media)
    cs.bsdf_types_b = bsdf_types_b
    cs.mix_kinds = mix_kinds
    cs.nmod_kinds = nmod_kinds
    cs.halton_setup = halton_setup
    cs.lh_depth = lh_depth
    cs.klems_info = klems_info
    cs.tensortree_info = tt_info
    cs.djmeasured_info = dj_info
    cs.parameter_values = scene_params
    cs.param_registry = param_registry
    # instanced-pool info for the two-level TLAS (ops/bw_tlas.py); None
    # when every entity bakes to the world soup
    cs.instanced = (dict(shapes=inst_shapes, records=inst_records)
                    if inst_records else None)
    return cs


_SLICE_BSDFS = (BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_CONDUCTOR, BSDF_PHONG,
                BSDF_PLASTIC, BSDF_PRINCIPLED, BSDF_PASSTHROUGH,
                BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
                BSDF_ROUGH_PLASTIC, BSDF_KLEMS, BSDF_TENSORTREE,
                BSDF_DJMEASURED)
# normal modifier kinds: 0 none, 1 normal map, 2 bump map, 3 the constant
# normal (and tangent) set, 4 a PExpr normal
_SLICE_NMODS = (0, 1, 2, 3, 4)
_SLICE_SELECTORS = ("uniform", "simple", "cdf", "hierarchy")


def check_slice(cs: CompiledScene) -> None:
    """Raise `NotImplementedError`, naming the feature, for anything a
    compiled scene asks for that the torch integrator does not cover yet."""
    def no(what):
        raise NotImplementedError(
            f"{what} is not ported to ignis_tpu_torch yet")

    if cs.technique.light_selector not in _SLICE_SELECTORS:
        no(f"light selector '{cs.technique.light_selector}'")
    for name, t, tb in zip(cs.material_names, cs.bsdf_types,
                           cs.bsdf_types_b):
        if t not in _SLICE_BSDFS or (tb >= 0 and tb not in _SLICE_BSDFS):
            no(f"BSDF type id {t if t not in _SLICE_BSDFS else tb} "
               f"(material '{name}')")
    if any(k not in _SLICE_NMODS for k in cs.nmod_kinds):
        no(f"normal modifier kinds {sorted(set(cs.nmod_kinds))}")


def _sun_direction(lobj) -> np.ndarray:
    """LoaderUtils::getDirection (LoaderUtils.cpp:140-156): direction |
    sun_direction | elevation/azimuth (Y-up EA frame)."""
    from ignis_tpu_torch.light import skysun
    return skysun.get_sun_direction(lobj)


def _bake_texture(textures, img_tables, tid, bw=1024, bh=512):
    """Bake a texture to an image for CDF building (ShadingTree::bakeTexture).

    Plain image textures use their own resolution; everything else evaluates
    on a bw x bh uv grid."""
    import torch
    from ignis_tpu_torch.texture.eval import eval_one
    from ignis_tpu_torch.texture.loader import TEX_IMAGE
    tex = textures[tid]
    if tex["type"] == TEX_IMAGE:
        return np.asarray(img_tables[tex["img_key"]])

    class _Stub:
        pass
    stub = _Stub()
    stub.textures = textures
    us = (np.arange(bw) + 0.5) / bw
    vs = (np.arange(bh) + 0.5) / bh
    uu, vv = np.meshgrid(us, vs)
    uv = torch.from_numpy(np.stack([uu.reshape(-1), vv.reshape(-1)],
                                   axis=-1).astype(np.float32))
    tabs = {k: torch.from_numpy(np.asarray(a, np.float32))
            for k, a in img_tables.items()}
    out = eval_one(stub, tabs, tex, uv).detach().numpy().astype(np.float32)
    # constant textures evaluate to a broadcastable shape ((3,) or (N, 1))
    # rather than (N, 3): broadcast before the grid reshape
    out = np.broadcast_to(np.atleast_2d(out), (bh * bw, 3))
    return out.reshape(bh, bw, 3)


def _detect_plane(world: TriMesh):
    """Detect a parallelogram plane shape (TriMeshProvider.cpp:560-610 analog).

    Returns (origin, x_axis, y_axis, normal, area) or None.
    """
    if world.face_count != 2 or world.vertices.shape[0] > 6:
        return None
    verts = np.unique(np.round(world.vertices[world.indices.reshape(-1)], 6), axis=0)
    if verts.shape[0] != 4:
        return None
    # Use the first triangle's corner layout: grid order v0=o, v1=o+x, v2=o+x+y, v3=o+y
    i = world.indices
    v = world.vertices
    # origin candidate: the vertex shared by both triangles twice
    counts: dict[bytes, int] = {}
    for idx in i.reshape(-1):
        key = np.round(v[idx], 6).tobytes()
        counts[key] = counts.get(key, 0) + 1
    shared = [np.frombuffer(k, dtype=v.dtype) for k, c in counts.items() if c == 2]
    single = [np.frombuffer(k, dtype=v.dtype) for k, c in counts.items() if c == 1]
    if len(shared) != 2 or len(single) != 2:
        return None
    # diagonal = the two shared vertices; o and far = the two singles
    o, far = single
    d1, d2 = shared
    xa = d1 - o
    ya = d2 - o
    if not np.allclose(o + xa + ya, far, atol=1e-4 * (1 + np.abs(far).max())):
        xa, ya = ya, xa
        if not np.allclose(o + xa + ya, far, atol=1e-4 * (1 + np.abs(far).max())):
            return None
    n = np.cross(xa, ya)
    area = float(np.linalg.norm(n))
    if area < 1e-12:
        return None
    n = n / area
    # orient consistently with the mesh's geometric normal of face 0
    fn = np.cross(v[i[0, 1]] - v[i[0, 0]], v[i[0, 2]] - v[i[0, 0]])
    if np.dot(fn, n) < 0:
        n = -n
        xa, ya = ya, xa  # keep right-handedness w.r.t. normal
    return (o.astype(np.float32), xa.astype(np.float32), ya.astype(np.float32),
            n.astype(np.float32), area)


def load_and_compile(path_or_dict, width=None, height=None) -> CompiledScene:
    if isinstance(path_or_dict, Scene):
        scene = path_or_dict
    elif isinstance(path_or_dict, dict):
        from ignis_tpu_torch.scene.parser import load_scene_dict
        scene = load_scene_dict(path_or_dict)
    elif isinstance(path_or_dict, str) and path_or_dict.lstrip().startswith("{"):
        scene = load_scene_string(path_or_dict)
    else:
        scene = load_scene_file(path_or_dict)
    return compile_scene(scene, width, height)
