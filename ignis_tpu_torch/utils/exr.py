"""Minimal OpenEXR scanline I/O (uncompressed float32 RGB).

Counterpart of ignis_tpu/utils/exr.py: writing uncompressed float32 RGB,
reading uncompressed and ZIP/ZIPS-compressed float32/half scanline files in
numpy and zlib.  Other compressions (PIZ, RLE, PXR24, B44, DWA) go to the
native OpenEXR shim (`native.load_exr_shim`); where it is absent or cannot
read the file, `read_exr` raises `ValueError`, as the JAX package does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(channels) -> bytes:
    out = b""
    for name in channels:
        # name, pixel type (2=float), pLinear, reserved, xSampling, ySampling
        out += name.encode() + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    return out + b"\0"


def write_exr(path, image: np.ndarray) -> None:
    """Write (H, W, 3) float32 RGB as uncompressed scanline EXR."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    assert c >= 3
    channels = ["B", "G", "R"]  # alphabetical, required by the format

    header = b""
    header += _attr("channels", "chlist", _chlist(channels))
    header += _attr("compression", "compression", b"\0")  # 0 = none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_size = 8 * h
    data_start = len(preamble) + table_size

    rows = []
    offsets = []
    off = data_start
    for y in range(h):
        row = b"".join(img[y, :, {"B": 2, "G": 1, "R": 0}[ch]].tobytes()
                       for ch in channels)
        block = struct.pack("<ii", y, len(row)) + row
        rows.append(block)
        offsets.append(off)
        off += len(block)

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}q", *offsets))
        f.write(b"".join(rows))


def _read_exr_native(path):
    """Read any EXR through the native OpenEXR shim; None when the shim is
    unavailable or cannot read the file."""
    import ctypes

    from ignis_tpu_torch.native import load_exr_shim
    lib = load_exr_shim()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    p = str(path).encode()
    if lib.ig_exr_read_size(p, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    buf = np.empty((h.value, w.value, 4), np.float32)
    if lib.ig_exr_read(
            p, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
        return None
    return np.ascontiguousarray(buf[..., :3])


def read_exr(path) -> np.ndarray:
    """Read scanline EXR (none/zip/zips compression; float/half) -> (H,W,3).
    Other compressions go to the native OpenEXR shim."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError("Not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        nend = data.index(b"\0", pos)
        name = data[pos:nend].decode()
        pos = nend + 1
        tend = data.index(b"\0", pos)
        typ = data[pos:tend].decode()
        pos = tend + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    comp = attrs["compression"][1][0]

    # channel list
    chraw = attrs["channels"][1]
    cpos = 0
    channels = []  # (name, pixeltype)
    while chraw[cpos] != 0:
        cend = chraw.index(b"\0", cpos)
        cname = chraw[cpos:cend].decode()
        ptype = struct.unpack_from("<i", chraw, cend + 1)[0]
        channels.append((cname, ptype))
        cpos = cend + 1 + 16
    channels_sorted = channels  # stored order == file order

    if comp == 0:
        rows_per_block = 1
    elif comp in (2, 3):  # ZIPS, ZIP
        rows_per_block = 1 if comp == 2 else 16
    else:
        # PIZ / RLE / PXR24 / B44 / DWA -> the native OpenEXR shim
        img = _read_exr_native(path)
        if img is not None:
            return img
        raise ValueError(f"Unsupported EXR compression {comp} "
                         f"(and no system OpenEXR library for fallback)")

    nblocks = (h + rows_per_block - 1) // rows_per_block
    offsets = struct.unpack_from(f"<{nblocks}q", data, pos)

    dt = {1: np.float16, 2: np.float32, 0: np.uint32}
    out = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        raw = data[off + 8:off + 8 + size]
        if comp in (2, 3):
            raw = zlib.decompress(raw)
            raw = _exr_unpredict(raw)
        rows = min(rows_per_block, h - (y - ymin))
        rpos = 0
        for r in range(rows):
            for cname, ptype in channels_sorted:
                nbytes = w * np.dtype(dt[ptype]).itemsize
                arr = np.frombuffer(raw, dtype=dt[ptype], count=w, offset=rpos)
                out[cname][y - ymin + r] = arr.astype(np.float32)
                rpos += nbytes

    names = [c for c, _ in channels]
    if all(k in out for k in ("R", "G", "B")):
        return np.stack([out["R"], out["G"], out["B"]], axis=-1)
    if "Y" in out:
        return np.stack([out["Y"]] * 3, axis=-1)
    first = out[names[0]]
    return np.stack([first] * 3, axis=-1)


def _exr_unpredict(buf: bytes) -> bytes:
    """Undo EXR's delta predictor + two-plane interleaving."""
    b = bytearray(buf)
    for i in range(1, len(b)):
        b[i] = (b[i] + b[i - 1] - 128) & 0xFF
    half = (len(b) + 1) // 2
    out = bytearray(len(b))
    out[0::2] = b[:half]
    out[1::2] = b[half:half + len(b) // 2]
    return bytes(out)
