"""Runtime API.  Counterpart of ignis_tpu/api.py.

`Runtime` owns the compiled scene, builds the acceleration tables, drives
progressive accumulation (`step()`) and exposes ray-list tracing (`trace()`),
checkpoints, tonemapping, image statistics and glare analysis of the frame.
The framebuffer is an unnormalized running sum with a sample count: consumers
divide by `currentSampleCount()` (or call `currentFrame()`).

`step()` runs the regenerating wavefront (`render_wavefront`) where it can;
the single-intersection techniques and scenes whose entities differ in camera
and bounce visibility go through the per-sample driver instead: for each
sample, `trace_wave` over tiles of `tile_size` pixels.  The light tracer
(`render/lighttracer.py`) traces `npix * spi` light paths a step, and the
photon mapper (`render/photonmapper.py`) one photon pass, its grid and one
camera pass a sample, each in tiles of `tile_size` lanes.

    rt = Runtime(scene_dict_or_path, width=512, height=512)   # on the card
    rt.step(spi=4)
    img = rt.currentFrame()

`device=None` means the CUDA device and raises when there is none; the CPU is
used only when the caller passes `device="cpu"`.  `use_bvh=True` adds the
binary-tree tables of the per-lane stack walk (`ops.bvh`), which the
traversal dispatch prefers to the Baldwin-Weber kernel (igcli's default, as
in the reference); `None` adds them above `_BVH_MIN_TRIS` triangles only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.render.integrator import (
    SIMPLE_TECHNIQUES, render_wavefront, trace_wave,
)
from ignis_tpu_torch.scene.compile import (
    CompiledScene, check_slice, load_and_compile,
)
from ignis_tpu_torch.utils.stats import (
    MEDIUM_COUNTS, Statistics, grid_lookups, host_syncs, medium_counts, span,
)

_DEFAULT_TILE = 1 << 16
# the techniques that trace paths from the lights, by every name the
# reference takes
LIGHT_TRACERS = ("lighttracer", "lt")
PHOTON_MAPPERS = ("photonmapper", "ppm", "sppm")
# Soups of this many triangles and more get packet-BVH tables and kernel,
# smaller ones Baldwin-Weber tables and kernel.  The value is the reference
# package's, kept so both packages build the same tables.
_PB_MIN_TRIS = 4096
# Soups of more triangles also get the binary-tree tables of the per-lane
# stack walk (`bvh_*`) unless the caller says otherwise (the reference's
# `use_bvh=None`); the dispatch reads them after the packet rows and before
# the Baldwin-Weber rows.
_BVH_MIN_TRIS = 8192


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


def build_accel_tables(tables, stats=None, instanced=None, use_bvh=None):
    """Host-side acceleration tables for a compiled scene's numpy tables:
    for the world-space soup the SAH BVH, its binary-tree traversal tables
    (`bvh_*`, where `use_bvh` is true, or None and the soup has more than
    `_BVH_MIN_TRIS` triangles), then packet-BVH rows (>= 4096 triangles, with
    the kernel's copy of them, `pb_nodes`) or Baldwin-Weber rows (fewer, with
    the kernel's cluster tree over them, `bw_ctree`), then the packed shading
    rows;
    for `instanced` (a compiled scene's `instanced` dict of unique shapes and
    instance records, or None) the two-level tables of `ops.tlas` and the
    kernel's cluster tree over them (`tl_ctree`).  The BVH, the packet rows
    and the Baldwin-Weber rows go through the asset cache
    (`utils.cache.cached_arrays_data`, kinds `bvh`, `pbvh`, `bwtab`, keyed on
    the geometry); `stats` records a build only where it ran.  Returns a new
    dict."""
    from ignis_tpu_torch.ops.bvh import BVH, build_bvh, bvh_tables
    from ignis_tpu_torch.utils.cache import cached_arrays_data

    def timed(name, build):
        def run():
            t0 = time.perf_counter()
            out = build()
            if stats is not None:
                stats.record(name, time.perf_counter() - t0)
            return out
        return run

    tables = dict(tables)
    ntris = tables["tri_v0"].shape[0]
    if ntris > 0:
        geo = (np.asarray(tables["tri_v0"]), np.asarray(tables["tri_e1"]),
               np.asarray(tables["tri_e2"]))

        def bvh_arrays():
            b = build_bvh(*geo)
            return dict(node_min=b.node_min, node_max=b.node_max,
                        node_left=b.node_left, node_right=b.node_right,
                        node_count=b.node_count, tri_order=b.tri_order)

        bvh = BVH(**cached_arrays_data(geo, "bvh",
                                       timed("build_bvh", bvh_arrays)))
        if use_bvh is None:
            use_bvh = ntris > _BVH_MIN_TRIS
        if use_bvh:
            tables = bvh_tables(bvh, tables)
        tri_flags = np.asarray(tables["ent_flags"])[
            np.asarray(tables["tri_ent"])]
        key = geo + (tri_flags,)
        if ntris >= _PB_MIN_TRIS:
            from ignis_tpu_torch.ops.packet_bvh import (
                build_packet_bvh, build_pb_nodes,
            )
            tables.update(cached_arrays_data(key, "pbvh", timed(
                "build_traversal_tables",
                lambda: build_packet_bvh(bvh, *geo, tri_flags))))
            tables["pb_nodes"] = timed(
                "build_pb_nodes", lambda: build_pb_nodes(tables["pb_rows"]))()
        else:
            from ignis_tpu_torch.ops.bw_intersect import (
                build_bw_ctree, bw_tables,
            )
            tables.update(cached_arrays_data(key, "bwtab", timed(
                "build_traversal_tables",
                lambda: bw_tables(*geo, tri_flags,
                                  order=np.asarray(bvh.tri_order)))))
            tables["bw_ctree"] = build_bw_ctree(tables["bw_clusters"])
        # the shading rows exist only beside a soup
        tables["tri_shade"] = pack_tri_shade(tables)
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
                 tile_size=_DEFAULT_TILE, use_bvh=None, device=None):
        device = resolve_device(device)
        stats = Statistics()
        t0 = time.perf_counter()
        scene = load_and_compile(source, width, height)
        check_slice(scene)
        stats.record("loading", time.perf_counter() - t0)
        tables = build_accel_tables(scene.tables, stats,
                                    instanced=scene.instanced,
                                    use_bvh=use_bvh)
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
        if "bw_clusters" in tables and "bw_ctree" not in tables:
            # the Baldwin-Weber kernel's cluster tree, derived likewise
            from ignis_tpu_torch.ops.bw_intersect import build_bw_ctree
            tables = dict(tables, bw_ctree=build_bw_ctree(
                tables["bw_clusters"]))
        if "tl_top" in tables and "tl_ctree" not in tables:
            # the kernel's cluster tree, derived from the pool's own tables
            from ignis_tpu_torch.ops.tlas import build_cluster_tree
            tables = dict(tables, tl_ctree=build_cluster_tree(
                tables["tl_clust"], tables["tl_inst"]))
        # the tables' move to the device, where the CUDA context starts
        with stats.section("upload"):
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
        # the media's events and ratio-tracker flights, added up on the
        # device by the steps (`utils.stats.count_medium`)
        self._medium_stats = torch.zeros(len(MEDIUM_COUNTS),
                                         dtype=torch.int64, device=device)
        self._first_step_done = False
        # the regenerating wavefront mixes camera and bounce rays in one
        # wave, so it needs both visibilities to agree per entity; else, and
        # for the single-intersection techniques, the per-sample driver
        ent_flags = np.asarray(scene.tables["ent_flags"])
        self._wavefront_ok = bool(
            (((ent_flags & 0x1) != 0) == ((ent_flags & 0x4) != 0)).all()
            and scene.technique.type not in SIMPLE_TECHNIQUES)

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

    def bake(self, texture, width=256, height=256) -> np.ndarray:
        """Bake a texture or PExpr expression to an (H, W, 3) image over the
        unit uv grid, uv = (x / (w - 1), y / (h - 1)), with no shading
        context.  `texture` is a scene texture NAME or a PExpr string.
        Registry parameters are read from the current `params` table."""
        from ignis_tpu_torch.texture.eval import eval_one
        from ignis_tpu_torch.texture.loader import TEX_EXPR
        tex = next((t for t in self.scene.textures
                    if t.get("name") == texture), None)
        if tex is None:
            tex = dict(type=TEX_EXPR, name="__bake", expr=str(texture),
                       obj={})
        us = np.arange(width, dtype=np.float32) / max(width - 1, 1)
        vs = np.arange(height, dtype=np.float32) / max(height - 1, 1)
        uu, vv = np.meshgrid(us, vs)
        uv = torch.from_numpy(np.stack([uu.reshape(-1), vv.reshape(-1)],
                                       axis=-1)).to(self.device)
        with torch.no_grad():
            out = eval_one(self.scene, self.tables, tex, uv)
        return out.cpu().numpy().reshape(height, width, 3)

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
        Returns after the device has finished the step.  The host's blocking
        reads of device values in it are added to the `HostSyncs`
        quantity, the heterogeneous media's grid lookups it issued to
        `MediumLookups`."""
        t0 = time.perf_counter()
        with span("step", request=self.iteration):
            syncs, lookups = host_syncs(), grid_lookups()
            with medium_counts(self._medium_stats):
                self._step_impl(spi)
            self.stats.add("HostSyncs", host_syncs() - syncs)
            if grid_lookups() > lookups:
                self.stats.add("MediumLookups", grid_lookups() - lookups)
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
        w = self.scene.width
        npix = w * self.scene.height
        if self.scene.technique.type in LIGHT_TRACERS + PHOTON_MAPPERS:
            with torch.no_grad():
                self._step_light_paths(spi)
        elif self._wavefront_ok:
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
        else:
            with torch.no_grad():
                self._per_sample(spi, lambda x, y, sample: trace_wave(
                    self.scene, self.tables, x, y, sample, self.iteration,
                    self.frame, self.seed))
        self._samples += spi
        self.iteration += 1

    def _per_sample(self, spi, render):
        """The per-sample driver: for each sample, `render(x, y, sample)` on
        tiles of `tile_size` pixels.  Every tile is that many lanes wide, the
        last one padded with copies of the film's last pixel, of which only
        the first `count` rows are added."""
        w = self.scene.width
        npix = w * self.scene.height
        tile = min(self.tile_size, npix)
        for sample in range(spi):
            for start in range(0, npix, tile):
                count = min(tile, npix - start)
                idx = torch.clamp_max(torch.arange(
                    start, start + tile, dtype=torch.int32,
                    device=self.device), npix - 1)
                color = render(idx % w, idx // w, sample)
                self._accum[start:start + count] += color[:count]

    def _step_light_paths(self, spi):
        """A step of the light tracer or the photon mapper."""
        from ignis_tpu_torch.render.lighttracer import render_lighttracer
        from ignis_tpu_torch.render.photonmapper import (
            build_photon_grid, ppm_compute_radius, render_ppm, trace_photons,
        )
        scene = self.scene
        npix = scene.width * scene.height
        if scene.technique.type in LIGHT_TRACERS:
            self._accum += render_lighttracer(
                scene, self.tables, npix * spi, self.iteration, self.frame,
                self.seed, tile=self.tile_size)
            return
        nph = int(scene.technique.photons)
        photons = trace_photons(scene, self.tables, nph, self.iteration,
                                self.frame, self.seed, tile=self.tile_size)
        grid = build_photon_grid(scene, photons)
        radius = float(np.float32(ppm_compute_radius(
            scene.technique.merge_radius * 2.0 * scene.scene_radius(),
            self.iteration)))
        self._per_sample(spi, lambda x, y, sample: render_ppm(
            scene, self.tables, grid, x, y, sample, self.iteration,
            self.frame, self.seed, radius, nph))

    # -------------------------------------------------------- checkpointing
    def saveCheckpoint(self, path):
        """Save the render state: the framebuffer sum, the sample, iteration
        and frame counters and the seed.  The random numbers are keyed on
        (sample, iteration, frame, x, y, seed), so a resumed run steps to the
        same bits as an uninterrupted one."""
        np.savez_compressed(
            path, accum=self._accum.cpu().numpy(), samples=self._samples,
            iteration=self.iteration, frame=self.frame, seed=self.seed,
            width=self.scene.width, height=self.scene.height)

    def loadCheckpoint(self, path):
        """Restore a state saved by `saveCheckpoint`; a checkpoint of another
        film size raises `ValueError`."""
        with np.load(path) as z:
            if (int(z["width"]) != self.scene.width
                    or int(z["height"]) != self.scene.height):
                raise ValueError(
                    f"checkpoint film {int(z['width'])}x{int(z['height'])} "
                    f"does not match runtime "
                    f"{self.scene.width}x{self.scene.height}")
            self._accum = torch.from_numpy(
                np.array(z["accum"], np.float32)).to(self.device)
            self._samples = int(z["samples"])
            self.iteration = int(z["iteration"])
            self.frame = int(z["frame"])
            self.seed = int(z["seed"])

    def dumpStats(self) -> str:
        """Section timers and quantities, plus the wavefront's occupancy and
        ray counters (none when only the per-sample driver ran) and, under
        `volpath`, the media's null, scatter and absorption events and
        ratio-tracker flights (`MediumNullEvents`, `MediumScatters`,
        `MediumAbsorbs`, `RatioFlights`)."""
        if self.scene.technique.type == "volpath":
            for name, v in zip(MEDIUM_COUNTS,
                               self._medium_stats.cpu().tolist()):
                self.stats.set(name, int(v))
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

    # ------------------------------------------------------- image analysis
    def tonemap(self, method="aces", scale=1.0, exposure_factor=1.0,
                offset=0.0, gamma=True):
        """The current frame tonemapped, (H, W, 3) float in [0, 1] (numpy).
        `method`: none, reinhard, modified, aces, uncharted2, or its
        number."""
        from ignis_tpu_torch.render.tonemap import METHODS
        from ignis_tpu_torch.render.tonemap import tonemap as _tm
        m = METHODS[method] if isinstance(method, str) else int(method)
        out = _tm(self._frame_tensor(), method=m, scale=scale,
                  exposure_factor=exposure_factor, exposure_offset=offset,
                  use_gamma=gamma)
        return np.clip(out.cpu().numpy(), 0.0, 1.0)

    def imageinfo(self, scale=1.0, bins=64, histogram=False,
                  percentile=False):
        """Luminance min / max / avg and NaN / Inf / negative pixel counts of
        the current frame (+ the histogram and soft percentiles); numpy
        values."""
        from ignis_tpu_torch.render.tonemap import image_info
        out = image_info(self._frame_tensor(), scale=scale, bins=bins,
                         histogram=histogram, percentile=percentile)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def evaluateGlare(self, settings=None, **kw):
        """Daylight glare probability of the current frame.

        Returns (GlareOutput, heatmap (H, W, 3), glare-source mask (H, W)),
        numpy.  Where `settings.avg` or `settings.max` is not positive, the
        frame's average or largest luminance (finite pixels) is used."""
        from ignis_tpu_torch.render.glare import (
            GlareSettings, complete_settings, evaluate_glare_host,
        )
        if settings is None:
            settings = GlareSettings(**kw)
        img = self._frame_tensor()
        settings = complete_settings(img, settings)
        return evaluate_glare_host(self.scene.camera, img, settings)

    def _frame_tensor(self):
        """The normalized frame (H, W, 3) on the device, as `currentFrame`
        computes it."""
        w, h = self.scene.width, self.scene.height
        return (self._accum / float(max(1, self._samples))).reshape(h, w, 3)

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


def load_scene(source, **kw) -> Runtime:
    """`Runtime(source, **kw)`: a scene file, a scene dict or JSON text."""
    return Runtime(source, **kw)
