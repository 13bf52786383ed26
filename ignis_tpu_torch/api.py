"""Runtime API.  Counterpart of ignis_tpu/api.py for the `path` technique.

`Runtime` owns the compiled scene, builds the acceleration tables, drives
progressive accumulation (`step()`) and exposes ray-list tracing (`trace()`).
The framebuffer is an unnormalized running sum with a sample count: consumers
divide by `currentSampleCount()` (or call `currentFrame()`).

    rt = Runtime(scene_dict_or_path, width=512, height=512)   # on the card
    rt.step(spi=4)
    img = rt.currentFrame()

`device=None` means the CUDA device and raises when there is none; the CPU is
used only when the caller passes `device="cpu"`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.render.integrator import render_wavefront, trace_wave
from ignis_tpu_torch.scene.compile import (
    CompiledScene, check_slice, load_and_compile,
)
from ignis_tpu_torch.utils.stats import Statistics

_DEFAULT_TILE = 1 << 16
# Soups of this many triangles and more get packet-BVH tables and kernel,
# smaller ones Baldwin-Weber tables and kernel.  The value is the reference
# package's, kept so both packages build the same tables.
_PB_MIN_TRIS = 4096


def resolve_device(device):
    """The device of a run: the CUDA device unless the caller names one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ignis_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def pack_tri_shade(tables):
    """(T, 28) f32: v0|e1|e2|n0|n1|n2|uv0|uv1|uv2|ent|mat|light|pad.
    One row gather per bounce instead of twelve.  The ids are stored as
    float32, exact below 2^24."""
    t = np.asarray(tables["tri_v0"]).shape[0]
    out = np.zeros((t, 28), np.float32)
    out[:, 0:3] = np.asarray(tables["tri_v0"], np.float32)
    out[:, 3:6] = np.asarray(tables["tri_e1"], np.float32)
    out[:, 6:9] = np.asarray(tables["tri_e2"], np.float32)
    out[:, 9:12] = np.asarray(tables["tri_n0"], np.float32)
    out[:, 12:15] = np.asarray(tables["tri_n1"], np.float32)
    out[:, 15:18] = np.asarray(tables["tri_n2"], np.float32)
    out[:, 18:20] = np.asarray(tables["tri_uv0"], np.float32)
    out[:, 20:22] = np.asarray(tables["tri_uv1"], np.float32)
    out[:, 22:24] = np.asarray(tables["tri_uv2"], np.float32)
    ent = np.asarray(tables["tri_ent"])
    out[:, 24] = ent.astype(np.float32)
    out[:, 25] = np.asarray(tables["ent_mat"])[ent].astype(np.float32)
    out[:, 26] = np.asarray(tables["ent_light"])[ent].astype(np.float32)
    return out


def build_accel_tables(tables, stats=None, instanced=None):
    """Host-side acceleration tables for a compiled scene's numpy tables:
    for the world-space soup the SAH BVH, then packet-BVH rows (>= 4096
    triangles, with the kernel's copy of them, `pb_nodes`) or Baldwin-Weber
    rows (fewer), then the packed shading rows;
    for `instanced` (a compiled scene's `instanced` dict of unique shapes and
    instance records, or None) the two-level tables of `ops.tlas` and the
    kernel's cluster tree over them (`tl_ctree`).  Returns a new dict."""
    from ignis_tpu_torch.ops.bvh import build_bvh
    tables = dict(tables)
    ntris = tables["tri_v0"].shape[0]
    if ntris > 0:
        geo = (np.asarray(tables["tri_v0"]), np.asarray(tables["tri_e1"]),
               np.asarray(tables["tri_e2"]))
        t0 = time.perf_counter()
        bvh = build_bvh(*geo)
        t1 = time.perf_counter()
        tri_flags = np.asarray(tables["ent_flags"])[
            np.asarray(tables["tri_ent"])]
        if ntris >= _PB_MIN_TRIS:
            from ignis_tpu_torch.ops.packet_bvh import (
                build_packet_bvh, build_pb_nodes,
            )
            tables.update(build_packet_bvh(bvh, *geo, tri_flags))
            t3 = time.perf_counter()
            tables["pb_nodes"] = build_pb_nodes(tables["pb_rows"])
            if stats is not None:
                stats.record("build_pb_nodes", time.perf_counter() - t3)
        else:
            from ignis_tpu_torch.ops.bw_intersect import bw_tables
            tables.update(bw_tables(*geo, tri_flags,
                                    order=np.asarray(bvh.tri_order)))
        t2 = time.perf_counter()
        # the shading rows exist only beside a soup
        tables["tri_shade"] = pack_tri_shade(tables)
        if stats is not None:
            stats.record("build_bvh", t1 - t0)
            stats.record("build_traversal_tables", t2 - t1)
    if instanced:
        from ignis_tpu_torch.ops.tlas import (
            build_cluster_tree, build_tlas, check_encoding,
        )
        t0 = time.perf_counter()
        tables.update(build_tlas(instanced["shapes"], instanced["records"]))
        nsph = tables["sph_rows"].shape[0] if "sph_rows" in tables else 0
        check_encoding(ntris, tables, nsph)
        t1 = time.perf_counter()
        tables["tl_ctree"] = build_cluster_tree(tables["tl_clust"],
                                                tables["tl_inst"])
        if stats is not None:
            stats.record("build_tlas", t1 - t0)
            stats.record("build_cluster_tree", time.perf_counter() - t1)
    return tables


class Runtime:
    def __init__(self, source, width=None, height=None, seed=0,
                 tile_size=_DEFAULT_TILE, device=None):
        device = resolve_device(device)
        stats = Statistics()
        t0 = time.perf_counter()
        scene = load_and_compile(source, width, height)
        check_slice(scene)
        stats.record("loading", time.perf_counter() - t0)
        tables = build_accel_tables(scene.tables, stats,
                                    instanced=scene.instanced)
        self._setup(scene, tables, device, seed, tile_size, stats)

    @classmethod
    def from_compiled(cls, scene: CompiledScene, tables, device=None, seed=0,
                      tile_size=_DEFAULT_TILE):
        """A Runtime over an already compiled scene and its (numpy) runtime
        tables, used as they are."""
        self = cls.__new__(cls)
        device = resolve_device(device)
        check_slice(scene)
        self._setup(scene, tables, device, seed, tile_size, Statistics())
        return self

    def _setup(self, scene, tables, device, seed, tile_size, stats):
        from ignis_tpu_torch.utils.log import logger
        self.scene = scene
        self.device = device
        self.stats = stats
        logger.info("Loaded scene: %dx%d, %d tris, %d materials, %d lights",
                    scene.width, scene.height, tables["tri_v0"].shape[0],
                    len(scene.material_names), scene.num_lights)
        if "tl_top" in tables and "tl_depth" not in tables:
            # tables built elsewhere: walk the top rows once, here on the
            # host, so that a launch only reads the scalar
            from ignis_tpu_torch.ops.tlas import top_depth
            tables = dict(tables, tl_depth=np.int32(top_depth(tables["tl_top"])))
        if "pb_rows" in tables and "pb_nodes" not in tables:
            # the packet-BVH kernel's copy of the rows, derived from them
            from ignis_tpu_torch.ops.packet_bvh import build_pb_nodes
            tables = dict(tables, pb_nodes=build_pb_nodes(tables["pb_rows"]))
        if "tl_top" in tables and "tl_ctree" not in tables:
            # the kernel's cluster tree, derived from the pool's own tables
            from ignis_tpu_torch.ops.tlas import build_cluster_tree
            tables = dict(tables, tl_ctree=build_cluster_tree(
                tables["tl_clust"], tables["tl_inst"]))
        self.tables = tables_from_numpy(tables, device)
        self.seed = int(seed)
        self.iteration = 0
        self.frame = 0
        self.tile_size = int(tile_size)
        w, h = scene.width, scene.height
        # device-resident accumulation; the host sees it at currentFrame()
        self._accum = torch.zeros((h * w, 3), dtype=torch.float32,
                                  device=device)
        self._samples = 0
        self._dev_stats = torch.zeros(9, dtype=torch.float32, device=device)
        self._dev_stats_capacity = 0
        self._first_step_done = False

    # ------------------------------------------------------------------ info
    @property
    def width(self):
        return self.scene.width

    @property
    def height(self):
        return self.scene.height

    def currentSampleCount(self):
        return self._samples

    # --------------------------------------------------------- parameters
    def setParameter(self, name, value):
        """Set a registry parameter (scene `parameters` or the built-in
        __camera_* / __time keys); unknown names raise KeyError."""
        reg = self.scene.param_registry
        if name not in reg:
            raise KeyError(f"unknown registry parameter '{name}' (declared: "
                           f"{sorted(reg)})")
        _, off, size = reg[name]
        v = np.asarray(value, np.float32).reshape(-1)
        if v.size == 1 and size > 1:
            v = np.full(size, v[0], np.float32)
        if v.size < size:
            v = np.concatenate([v, np.ones(size - v.size, np.float32)])
        # in place: `params` is a small table the emitters read every step
        self.tables["params"][off:off + size] = torch.from_numpy(
            v[:size].copy()).to(self.device)

    def getParameter(self, name):
        kind, off, size = self.scene.param_registry[name]
        v = self.tables["params"][off:off + size].cpu().numpy()
        return float(v[0]) if kind in ("num", "int") else v

    def setCameraOrientationParameter(self, eye, dir, up):
        self.setParameter("__camera_eye", eye)
        self.setParameter("__camera_dir", dir)
        self.setParameter("__camera_up", up)

    # ------------------------------------------------------------------ render
    def reset(self):
        self._accum.zero_()
        self._samples = 0
        self.iteration = 0

    def step(self, spi=1):
        """Render `spi` samples/pixel for this iteration and accumulate.
        Returns after the device has finished the step."""
        t0 = time.perf_counter()
        self._step_impl(spi)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        # the first step includes the kernels' build and load
        name = "step" if self._first_step_done else "first step"
        self._first_step_done = True
        npix = self.scene.width * self.scene.height
        self.stats.record(name, dt, workload=npix * spi)
        self.stats.add("CameraRayCount", npix * spi)
        self.stats.add("Iterations", 1)

    def _step_impl(self, spi=1):
        npix = self.scene.width * self.scene.height
        total = npix * spi
        capacity = int(min(self.tile_size, max(8192, 1 << int(np.ceil(
            np.log2(max(total, 1)))))))
        with torch.no_grad():
            fb, wstats = render_wavefront(
                self.scene, self.tables, self.iteration, self.frame,
                self.seed, capacity=capacity, spi=spi)
        self._accum += fb  # in place: the running sum lives on the device
        self._dev_stats += wstats
        self._dev_stats_capacity = capacity
        self._samples += spi
        self.iteration += 1

    def dumpStats(self) -> str:
        """Section timers and quantities, plus the wavefront's occupancy and
        ray counters."""
        ds = self._dev_stats.cpu().numpy()
        if ds[0] > 0:
            cap = max(self._dev_stats_capacity, 1)
            self.stats.set("WaveIterations", int(ds[0]))
            self.stats.set("TailIterations", int(ds[2]))
            self.stats.set("BounceLaneVisits", int(ds[1]))
            self.stats.set("WaveOccupancy", float(ds[1] / (ds[0] * cap)))
            self.stats.set("CameraRayCount(device)", int(ds[3]))
            # ds[4]/ds[5] sum hit/miss over EVERY bounce of every wave
            self.stats.set("RayHitCount", int(ds[4]))
            self.stats.set("RayMissCount", int(ds[5]))
            self.stats.set("ShadowRayCount", int(ds[6]))
            self.stats.set("OccludedShadowRayCount", int(ds[7]))
            self.stats.set("BounceRayCount", int(ds[8]))
            if ds[6] > 0:
                self.stats.set("ShadowOcclusionRatio", float(ds[7] / ds[6]))
        return self.stats.dump()

    def currentFrame(self) -> np.ndarray:
        """Normalized framebuffer (H, W, 3)."""
        w, h = self.scene.width, self.scene.height
        norm = max(1, self._samples)
        return (self._accum.cpu().numpy() / norm).reshape(h, w, 3)

    def rawFramebuffer(self) -> np.ndarray:
        w, h = self.scene.width, self.scene.height
        return self._accum.cpu().numpy().reshape(h, w, 3)

    # ------------------------------------------------------------------ trace
    def trace(self, rays, spp=1) -> np.ndarray:
        """Ray-list tracing: rays = [(org, dir[, tmin, tmax]), ...].

        The film is (n_rays, 1): ray i maps to pixel (i, 0).  Returns the
        per-ray RGB averaged over `spp` iterations.
        """
        rays = list(rays)
        n = len(rays)
        org = np.zeros((n, 3), np.float32)
        dirs = np.zeros((n, 3), np.float32)
        tmin = np.zeros((n,), np.float32)
        tmax = np.full((n,), np.float32(3.4028235e38), np.float32)
        for i, r in enumerate(rays):
            org[i] = r[0]
            dirs[i] = r[1]
            if len(r) > 2:
                tmin[i] = r[2]
            if len(r) > 3:
                tmax[i] = r[3]
        dev = self.device
        x = torch.arange(n, dtype=torch.int32, device=dev)
        y = torch.zeros(n, dtype=torch.int32, device=dev)
        to = lambda a: torch.from_numpy(a).to(dev)
        org, dirs, tmin, tmax = to(org), to(dirs), to(tmin), to(tmax)
        spp = max(1, spp)
        acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for it in range(spp):
                acc += trace_wave(self.scene, self.tables, x, y, 0, it,
                                  self.frame, self.seed, org=org,
                                  direction=dirs, tmin=tmin, tmax=tmax)
        return (acc / float(spp)).cpu().numpy()
