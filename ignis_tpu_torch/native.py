"""Build and load the hand-written CUDA kernels and the OpenEXR shim.

The sources in `csrc/` have a plain C interface and include no PyTorch header,
so `nvcc` builds them in seconds.  They are compiled at first use (one `nvcc`
per source, all started together, then one link) into a single shared library
under `build/ignis_tpu_torch/` beside the package and loaded with `ctypes`.
A failed build raises; nothing falls back to another implementation.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu
    nvcc -shared -o libignis_kernels.so *.o

`load_exr_shim()` builds `csrc/exr_shim.cpp` (host code over the system's
OpenEXR 3.1, for the EXR compressions `utils.exr` does not decode itself)
with `g++` into the same directory at first use, rebuilt when the source
changes, and returns None where the library or the compiler is absent.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("bw_intersect.cu", "packet_bvh.cu", "tlas.cu", "mt_intersect.cu",
           "row_scatter.cu")
# -fmad=false: the kernels repeat their plain PyTorch versions' arithmetic
# term by term; contraction into fused multiply-adds would change last bits.
# -Xptxas -v: registers, shared memory and spills of each kernel go into the
# build log (`build_info["log"]`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info: dict = {}


def build_dir() -> Path:
    return _PKG.parent / "build" / "ignis_tpu_torch"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of ignis_tpu_torch "
                       "cannot be built (set CUDA_HOME or put nvcc on PATH)")


def nvcc_release(nvcc: str | None = None) -> str:
    out = subprocess.run([nvcc or find_nvcc(), "--version"], check=True,
                         capture_output=True, text=True).stdout
    for line in out.splitlines():
        if "release" in line:
            return line.strip()
    return out.strip().splitlines()[-1]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # headers too: a changed `.cuh` must rebuild what includes it
    for path in [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link them; returns the library
    path.  Reuses a library built from identical sources and flags."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = out_dir / f"libignis_kernels_{_digest()}.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, library=str(lib_path), cached=True)
        return lib_path
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, logs = [], []
    failed = None
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"--- {name}\n{out}")
        if proc.returncode != 0 and failed is None:
            failed = name
        objs.append(str(obj))
    if failed is not None:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / (lib_path.name + f".tmp{os.getpid()}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, lib_path)
    build_info.update(seconds=time.perf_counter() - t0, library=str(lib_path),
                      cached=False, log="\n".join(logs))
    return lib_path


_P, _I = ctypes.c_void_p, ctypes.c_int
MT_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
               _P]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ignis_bw_intersect.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _P, _P, _P, _P, _P]
        lib.ignis_bw_intersect.restype = _I
        lib.ignis_packet_bvh.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P,
                                         _P, _P, _P, _P]
        lib.ignis_packet_bvh.restype = _I
        lib.ignis_packet_bvh_stack_entries.argtypes = []
        lib.ignis_packet_bvh_stack_entries.restype = _I
        lib.ignis_tlas.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _P, _P, _P, _P, _P, _P]
        lib.ignis_tlas.restype = _I
        lib.ignis_tlas_stack_entries.argtypes = []
        lib.ignis_tlas_stack_entries.restype = _I
        lib.ignis_mt_intersect.argtypes = MT_ARGTYPES
        lib.ignis_mt_intersect.restype = _I
        lib.ignis_row_scatter.argtypes = [_P, _P] + [_I] * 9 + [_P, _P, _P]
        lib.ignis_row_scatter.restype = _I
        _lib = lib
    return _lib


def check_rays(org, d, tmin, tmax):
    """Validate ray tensors for a kernel launch: CUDA, float32, org/d (N, 3),
    tmin/tmax numbers or tensors that broadcast to (N,).  Returns them
    contiguous; tensors that already are pass through untouched, so a launch
    from the bounce loop costs no extra device work."""
    if not org.is_cuda:
        raise ValueError("kernel launch needs CUDA tensors")
    if org.ndim != 2 or org.shape[1] != 3 or d.shape != org.shape:
        raise ValueError(f"org/d must be (N, 3), got {tuple(org.shape)} and "
                         f"{tuple(d.shape)}")
    n = org.shape[0]
    dev = org.device
    out = []
    for name, x in (("org", org), ("d", d), ("tmin", tmin), ("tmax", tmax)):
        if not isinstance(x, torch.Tensor):
            x = torch.full((n,), float(x), dtype=torch.float32, device=dev)
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
        if name[0] == "t" and x.shape != (n,):
            x = torch.broadcast_to(x, (n,))
        out.append(x.contiguous())
    return out


def hit_outputs(n, device):
    """Uninitialised (t, u, v, prim) outputs of a launch over n rays: three
    float32 and one int32 (n,) tensors, rows of one allocation."""
    buf = torch.empty((4, n), dtype=torch.float32, device=device)
    return buf[0], buf[1], buf[2], buf[3].view(torch.int32)


def launch_guard(device):
    """Context in which `device` is the current CUDA device, so a kernel
    launched through `ctypes` lands on it; free when it already is."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_table(name, t, cols, device):
    if (t.device != device or t.dtype != torch.float32 or t.ndim != 2
            or t.shape[1] != cols or not t.is_contiguous()
            or t.data_ptr() % 16 != 0):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"float32 (R, {cols}) tensor on {device}")
    return t


# ------------------------------------------------------------ the EXR shim
EXR_SHIM = "exr_shim.cpp"
_EXR_LIBS = ("-lOpenEXR-3_1", "-lImath-3_1", "-lIlmThread-3_1", "-lIex-3_1")
_exr_shim = None
_exr_tried = False


def _build_exr_shim() -> Path:
    src = CSRC / EXR_SHIM
    inc = [f"-I{d}" for d in ("/usr/include/OpenEXR", "/usr/include/Imath")
           if os.path.isdir(d)]
    flags = ["-O2", "-shared", "-fPIC", *inc]
    h = hashlib.sha256(" ".join(flags + list(_EXR_LIBS)).encode())
    h.update(src.read_bytes())
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = out_dir / f"libexr_shim_{h.hexdigest()[:16]}.so"
    if not so.exists():
        tmp = out_dir / f"{so.name}.tmp{os.getpid()}"
        subprocess.run(["g++", *flags, "-o", str(tmp), str(src),
                        *_EXR_LIBS], check=True, capture_output=True,
                       text=True)
        os.replace(tmp, so)
    return so


def load_exr_shim():
    """ctypes handle of the OpenEXR reader shim (`ig_exr_read_size`,
    `ig_exr_read`), or None when the system OpenEXR library (or g++) is
    unavailable.  Built and loaded once a process."""
    global _exr_shim, _exr_tried
    if _exr_tried:
        return _exr_shim
    _exr_tried = True
    try:
        lib = ctypes.CDLL(str(_build_exr_shim()))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.ig_exr_read_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.ig_exr_read_size.restype = ctypes.c_int
    lib.ig_exr_read.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_float)]
    lib.ig_exr_read.restype = ctypes.c_int
    _exr_shim = lib
    return lib
