"""Minimal NanoVDB (.nvdb) reader -> dense density grid, and a writer.

Counterpart of ignis_tpu/medium/nanovdb.py (numpy and `struct` only; the
port keeps its own copy).  Instead of walking the sparse tree on the device,
the loader densifies at load time: the leaf-node array (contiguous in the
NanoVDB buffer) is scattered into a dense (D,H,W) float32 array covering the
grid's index bounding box, which the volume lookups gather from.

Supported: uncompressed (codec NONE) float grids, NanoVDB data layout
version 32.x (the "NanoVDB0" magic).  Internal-node value tiles — constant
regions promoted above leaf level — are rare in fog volumes; files using
them are rejected loudly rather than read wrong.

File layout parsed here:
  FileHeader { u64 magic; u32 version; u16 gridCount; u16 codec }
  per grid: FileMetaData (176 B) + grid name + grid blob
  grid blob: GridData (672 B) | TreeData (64 B) | root | internals | leaves
  LeafData<float> (2144 B): CoordT bboxMin (12) | u8 bboxDif[3] | u8 flags
    | 64 B value mask | min/max/avg/stddev (16) | f32 values[512]
"""

from __future__ import annotations

import struct

import numpy as np

NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0"
_FILE_HEADER = struct.Struct("<QIHH")
# FileMetaData: gridSize, fileSize, nameKey, voxelCount, gridType, gridClass,
# worldBBox (6d), indexBBox (6i), voxelSize (3d), nameSize, nodeCount[4],
# tileCount[3], codec, padding, version
_FILE_META = struct.Struct("<4Q2I6d6i3dI4I3IHHI")
assert _FILE_META.size == 176

_GRID_TYPE_FLOAT = 1
_LEAF_SIZE = 2144
_LEAF_VALUES_OFF = 96
# leaves the loader copies out of the file at a time
_LEAF_CHUNK = 1 << 15


def _parse_file(raw):
    magic, version, grid_count, codec = _FILE_HEADER.unpack_from(raw, 0)
    if magic != NANOVDB_MAGIC:
        raise ValueError("Not a NanoVDB file (bad magic)")
    if codec != 0:
        raise ValueError(f"Compressed .nvdb (codec={codec}) not supported; "
                         "re-save uncompressed")
    off = _FILE_HEADER.size
    grids = []
    for _ in range(grid_count):
        m = _FILE_META.unpack_from(raw, off)
        off += _FILE_META.size
        (grid_size, file_size, _name_key, _voxel_count, grid_type,
         grid_class) = m[0:6]
        index_bbox = m[12:18]
        name_size = m[21]
        node_count = m[22:26]
        tile_count = m[26:29]
        name = bytes(raw[off:off + name_size]).split(b"\0")[0].decode()
        off += name_size
        grids.append(dict(name=name, offset=off, grid_size=grid_size,
                          grid_type=grid_type, grid_class=grid_class,
                          index_bbox=index_bbox, node_count=node_count,
                          tile_count=tile_count))
        off += grid_size
    return grids


def load_nvdb_grid(path, grid_name: str = "density") -> np.ndarray:
    """Read one named float grid from a .nvdb file as a dense (D,H,W)
    float32 array over its index bbox (z-major to match voxel grids).

    The file is mapped, not read whole: leaves are copied out of the map a
    chunk at a time, and the leaves that lie inside the bbox on the 8-voxel
    lattice are written into the dense array by block in one scatter a
    chunk; the others (on its far faces, or off the lattice) one by one."""
    raw = np.memmap(path, np.uint8, mode="r")
    grids = _parse_file(raw)
    grid = next((g for g in grids if g["name"] == grid_name), None)
    if grid is None:
        names = [g["name"] for g in grids]
        raise ValueError(f"Grid '{grid_name}' not in {path} "
                         f"(available: {names})")
    if grid["grid_type"] != _GRID_TYPE_FLOAT:
        raise ValueError(f"Grid '{grid_name}' is not a float grid "
                         f"(type={grid['grid_type']})")
    if any(grid["tile_count"]):
        raise ValueError("NanoVDB grids with internal-node value tiles are "
                         "not supported by the dense loader")

    base = grid["offset"]
    # GridData (672 B) then TreeData: u64 nodeOffset[4] (leaf,lower,upper,
    # root, relative to tree start), u32 nodeCount[3], u32 tileCount[3],
    # u64 voxelCount
    tree = base + 672
    node_off = struct.unpack_from("<4Q", raw, tree)
    leaf_count = struct.unpack_from("<3I", raw, tree + 32)[0]
    if leaf_count != grid["node_count"][0]:
        raise ValueError("Leaf count mismatch between file metadata and "
                         "tree header — unsupported NanoVDB version?")

    ib = grid["index_bbox"]
    bmin = np.asarray(ib[0:3], np.int64)
    bmax = np.asarray(ib[3:6], np.int64)
    dims = bmax - bmin + 1  # (x, y, z)
    dense = np.zeros((dims[2], dims[1], dims[0]), np.float32)
    # the dense array as whole 8^3 blocks (bz, by, bx, z, y, x): a view
    nb = dims[::-1] // 8
    s = dense.strides
    blocks = np.lib.stride_tricks.as_strided(
        dense, tuple(nb) + (8, 8, 8), tuple(8 * np.asarray(s)) + s)

    leaves_at = tree + node_off[0]
    buf = raw[leaves_at:leaves_at + leaf_count * _LEAF_SIZE].reshape(
        leaf_count, _LEAF_SIZE)
    # one chunk's leaves, copied out of the map into a buffer kept for all
    chunk = np.empty((min(leaf_count, _LEAF_CHUNK), _LEAF_SIZE), np.uint8)
    for c0 in range(0, leaf_count, _LEAF_CHUNK):
        k = min(_LEAF_CHUNK, leaf_count - c0)
        np.copyto(chunk[:k], buf[c0:c0 + k])
        origins = chunk[:k, :12].copy().view(np.int32).reshape(k, 3)
        origins = origins & ~7  # active-bbox min → leaf origin
        inactive = ~np.unpackbits(chunk[:k, 16:80], axis=1,
                                  bitorder="little").astype(bool)
        values = chunk[:k, _LEAF_VALUES_OFF:_LEAF_VALUES_OFF + 2048] \
            .view(np.float32)
        np.copyto(values, np.float32(0.0), where=inactive)
        # NanoVDB leaf value order: v[((i&7)<<6)|((j&7)<<3)|(k&7)] → (x,y,z);
        # transposed → (z, y, x)
        vals = values.reshape(k, 8, 8, 8).transpose(0, 3, 2, 1)
        rel = origins - bmin
        whole = ((rel % 8 == 0).all(1) & (rel >= 0).all(1)
                 & (rel + 8 <= dims).all(1))
        bi = rel[whole] // 8
        blocks[bi[:, 2], bi[:, 1], bi[:, 0]] = vals[whole]
        for li in np.nonzero(~whole)[0]:
            ox, oy, oz = rel[li]
            xs, ys, zs = (slice(max(ox, 0), ox + 8), slice(max(oy, 0), oy + 8),
                          slice(max(oz, 0), oz + 8))
            v = vals[li]
            v = v[max(-oz, 0):dims[2] - oz, max(-oy, 0):dims[1] - oy,
                  max(-ox, 0):dims[0] - ox]
            dense[zs, ys, xs][: v.shape[0], : v.shape[1], : v.shape[2]] = v
    return dense


# ---------------------------------------------------------------------------
# Writer — used by tests (round-trip) and by tools converting dense grids to
# .nvdb.  Emits a minimal single-root-tile tree in the layout parsed above.
# ---------------------------------------------------------------------------

def _leaf_records(dense):
    """The leaf records (k, 2144) uint8 of the non-empty 8^3 blocks of a
    dense (D, H, W) grid, in the order z, y, x of their origins (x
    fastest), and the number of non-zero voxels; one slab of 8 z-slices
    at a time."""
    d, h, w = dense.shape
    ny, nx = -(-h // 8), -(-w // 8)
    bx, by = np.meshgrid(np.arange(nx, dtype=np.int32),
                         np.arange(ny, dtype=np.int32))
    xy = np.stack([bx.reshape(-1), by.reshape(-1)], axis=1) * 8
    out, voxels = [], 0
    slab = np.zeros((8, ny * 8, nx * 8), np.float32)
    for oz in range(0, d, 8):
        sub = dense[oz:oz + 8]
        slab[...] = 0.0
        slab[: sub.shape[0], :h, :w] = sub
        # (by, bx, x, y, z): each block's values in the leaf's (x, y, z)
        # order
        vals = slab.reshape(8, ny, 8, nx, 8).transpose(1, 3, 4, 2, 0) \
            .reshape(ny * nx, 512)
        nonzero = vals != 0.0
        keep = nonzero.any(axis=1)
        vals, nonzero = vals[keep], nonzero[keep]
        k = vals.shape[0]
        voxels += int(nonzero.sum())
        if not k:
            continue
        rec = np.zeros((k, _LEAF_SIZE), np.uint8)
        org = np.empty((k, 3), "<i4")
        org[:, 0:2], org[:, 2] = xy[keep], oz
        rec[:, 0:12] = org.view(np.uint8)
        rec[:, 12:15] = 7
        rec[:, 16:80] = np.packbits(nonzero, axis=1, bitorder="little")
        st = np.stack([vals.min(axis=1), vals.max(axis=1), vals.mean(axis=1),
                       vals.std(axis=1)], axis=1).astype("<f4")
        rec[:, 80:96] = st.view(np.uint8)
        rec[:, _LEAF_VALUES_OFF:] = vals.astype("<f4").view(np.uint8)
        out.append(rec)
    return out, voxels


def write_nvdb_grid(path, dense: np.ndarray, grid_name: str = "density"):
    """Write a dense (D,H,W) float32 array as a minimal uncompressed .nvdb
    float fog-volume grid (single upper/lower internal node chain)."""
    dense = np.asarray(dense, np.float32)
    d, h, w = dense.shape
    if max(d, h, w) > 4096:
        raise ValueError("write_nvdb_grid supports grids up to 4096³")

    leaves, voxels = _leaf_records(dense)
    n_leaves = sum(r.shape[0] for r in leaves)
    leaf_bytes = n_leaves * _LEAF_SIZE

    # Minimal root/internal blobs: the dense reader never dereferences
    # them, but sizes must be consistent.  Root: 64 B header + 1 tile 32 B.
    root_blob = bytes(64 + 32)
    upper_blob = bytes(24 + 8 + 4096 + 4096 + 16 + 32768 * 8 + 48)
    lower_blob = bytes(24 + 8 + 512 + 512 + 16 + 4096 * 8 + 48)

    tree_hdr = struct.pack(
        "<4Q3I3IQ",
        64 + len(root_blob) + len(upper_blob) + len(lower_blob),  # leaf off
        64 + len(root_blob) + len(upper_blob),                    # lower off
        64 + len(root_blob),                                      # upper off
        64,                                                       # root off
        n_leaves, 1, 1,      # node counts (leaf, lower, upper)
        0, 0, 0,             # tile counts
        voxels)
    tree_blob = tree_hdr + bytes(64 - len(tree_hdr))

    grid_data = bytearray(672)
    struct.pack_into("<QQ", grid_data, 0, NANOVDB_MAGIC, 0)
    struct.pack_into("<I", grid_data, 16, (32 << 21) | (3 << 10))  # v32.3
    name_b = grid_name.encode()[:255]
    grid_data[40:40 + len(name_b)] = name_b
    grid_size = (len(grid_data) + len(tree_blob) + len(root_blob)
                 + len(upper_blob) + len(lower_blob) + leaf_bytes)
    struct.pack_into("<Q", grid_data, 32, grid_size)
    struct.pack_into("<II", grid_data, 632, 1, _GRID_TYPE_FLOAT)  # fog, f32

    name_field = grid_name.encode() + b"\0"
    meta = _FILE_META.pack(
        grid_size, grid_size, 0, voxels,
        _GRID_TYPE_FLOAT, 1,
        0.0, 0.0, 0.0, float(w), float(h), float(d),
        0, 0, 0, w - 1, h - 1, d - 1,
        1.0, 1.0, 1.0,
        len(name_field),
        n_leaves, 1, 1, 1,
        0, 0, 0,
        0, 0, (32 << 21) | (3 << 10))

    with open(path, "wb") as f:
        f.write(_FILE_HEADER.pack(NANOVDB_MAGIC, (32 << 21) | (3 << 10),
                                  1, 0))
        f.write(meta)
        f.write(name_field)
        f.write(bytes(grid_data))
        f.write(tree_blob)
        f.write(root_blob)
        f.write(upper_blob)
        f.write(lower_blob)
        for rec in leaves:
            f.write(rec.data)
