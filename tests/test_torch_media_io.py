"""Volume files across the two packages: `.bin` voxel grids and `.nvdb`
NanoVDB grids written by each package (or by the reference's test helper)
and read by the other.  Exact: the readers return the same arrays, bit for
bit, and the two `.nvdb` writers the same bytes."""

import struct

import numpy as np
import pytest

from ignis_tpu.medium import nanovdb as jn
from ignis_tpu.medium import volume as jv
from ignis_tpu_torch.medium import nanovdb as tn
from ignis_tpu_torch.medium import volume as tv


def _fields(seed, dims=(7, 5, 6)):
    rng = np.random.default_rng(seed)
    d, h, w = dims
    return [rng.uniform(0, 3, (d, h, w, 3)).astype(np.float32)
            for _ in range(3)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_bin_written_by_the_port_read_by_both(tmp_path):
    sa, ss, em = _fields(1)
    p = tmp_path / "g.bin"
    tv.write_voxel_grid_bin(p, sa, ss, em)
    got, ref = tv.load_voxel_grid_bin(p), jv.load_voxel_grid_bin(p)
    _same(got, ref)
    np.testing.assert_array_equal(got["sigma_a"], sa)
    np.testing.assert_array_equal(got["sigma_s"], ss)
    np.testing.assert_array_equal(got["emission"], em)
    assert (got["width"], got["height"], got["depth"]) == (6, 5, 7)


def test_bin_of_the_reference_test_helper_read_by_the_port(tmp_path):
    """tests/test_media.py's writer (a constant voxel repeated): x fastest,
    the padding floats skipped."""
    from test_media import _write_bin
    p = tmp_path / "h.bin"
    _write_bin(p, [0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [1, 2, 3],
               dims=(3, 2, 5))
    _same(tv.load_voxel_grid_bin(p), jv.load_voxel_grid_bin(p))
    g = tv.load_voxel_grid_bin(p)
    assert g["sigma_a"].shape == (5, 2, 3, 3)
    np.testing.assert_allclose(g["emission"][4, 1, 2], [1, 2, 3])


def test_bin_x_is_fastest(tmp_path):
    sa = np.zeros((2, 3, 4, 3), np.float32)
    sa[1, 2, 3] = [7, 8, 9]
    p = tmp_path / "x.bin"
    tv.write_voxel_grid_bin(p, sa, sa, sa)
    raw = p.read_bytes()
    assert struct.unpack_from("4I", raw, 0) == (4, 3, 2, 0)
    last = np.frombuffer(raw, np.float32, offset=len(raw) - 48, count=12)
    np.testing.assert_array_equal(last[0:3], [7, 8, 9])
    _same(tv.load_voxel_grid_bin(p), jv.load_voxel_grid_bin(p))


@pytest.mark.parametrize("dims", [(12, 9, 17), (8, 8, 8), (1, 3, 2),
                                  (20, 16, 9)])
def test_nvdb_written_by_each_read_by_the_other(tmp_path, dims):
    rng = np.random.default_rng(sum(dims))
    dense = rng.uniform(0, 1, dims).astype(np.float32)
    dense[dense < 0.3] = 0.0     # sparse: some leaves are empty
    pt, pj = tmp_path / "t.nvdb", tmp_path / "j.nvdb"
    tn.write_nvdb_grid(pt, dense, "density")
    jn.write_nvdb_grid(pj, dense, "density")
    assert pt.read_bytes() == pj.read_bytes()
    for reader in (tn.load_nvdb_grid, jn.load_nvdb_grid):
        np.testing.assert_array_equal(reader(pt, "density"), dense)
        np.testing.assert_array_equal(reader(pj, "density"), dense)


def test_nvdb_errors_match(tmp_path):
    dense = np.ones((8, 8, 8), np.float32)
    p = tmp_path / "c.nvdb"
    tn.write_nvdb_grid(p, dense, "smoke")
    for reader in (tn.load_nvdb_grid, jn.load_nvdb_grid):
        with pytest.raises(ValueError, match="temperature"):
            reader(p, "temperature")
    bad = tmp_path / "bad.nvdb"
    bad.write_bytes(b"\0" * 64)
    for reader in (tn.load_nvdb_grid, jn.load_nvdb_grid):
        with pytest.raises(ValueError, match="magic"):
            reader(bad)


def test_media_scene_grids_are_read_alike(tmp_path):
    """The port's `media_scene` writes its 128^3 cloud with the port's
    writer and its 64^3 voxel grid with `write_voxel_grid_bin`: both
    packages read them alike."""
    from ignis_tpu_torch.scenes import _media_grids
    cloud, glow = _media_grids(tmp_path, 11)
    c = tn.load_nvdb_grid(cloud)
    assert c.shape == (128, 128, 128) and c.max() > 0 and (c == 0).any()
    np.testing.assert_array_equal(c, jn.load_nvdb_grid(cloud))
    _same(tv.load_voxel_grid_bin(glow), jv.load_voxel_grid_bin(glow))
    assert tv.load_voxel_grid_bin(glow)["sigma_a"].shape == (64, 64, 64, 3)
