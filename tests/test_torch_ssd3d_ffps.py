"""F-FPS (K9's plain version, ``ops/cuda_fps.py::feature_fps``) and the
sampler specs (``ops/sampling.py``) on the CPU: exact picks against a
brute-force loop over several row counts, widths and row ranges,
constructed ties, the D-FPS case equal to K1's plain version, fusion
sampling's concatenation, a D-FPS sampler's method (PointRCNN's stages)
and the specs a sampler refuses."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pointrcnn_tpu_torch.ops import cuda_fps
from pointrcnn_tpu_torch.ops.sampling import (
    Sampler,
    _blockwise_stripes,
    furthest_point_sample,
    sample_points,
    sampler_spec,
)

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)


def brute_fps(rows: np.ndarray, npoint: int, start: int = 0, end: int | None = None):
    """The contract in a loop of f32 scalars: first pick the range's first
    row; the squared distance summed over the values in order; running
    minimum from 1e10; argmax, the lowest index on ties."""
    x = rows[start:end].astype(np.float32)
    n, d = x.shape
    mind = [np.float32(1e10)] * n
    picks, last = [0], 0
    for _ in range(1, npoint):
        best, arg = np.float32(-1.0), -1
        for i in range(n):
            acc = None
            for k in range(d):
                dk = np.float32(x[i, k] - x[last, k])
                acc = np.float32(dk * dk) if acc is None else np.float32(acc + np.float32(dk * dk))
            mind[i] = min(mind[i], acc)
            if mind[i] > best:
                best, arg = mind[i], i
        picks.append(arg)
        last = arg
    return np.array(picks) + start


def _rows(b, n, c, seed, scale=10.0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(b, n, 3, generator=g) * scale
    feats = torch.relu(torch.randn(b, n, c, generator=g)) * 2
    return torch.cat([xyz, feats], -1)


@pytest.mark.parametrize("n,c,npoint,start,end", [(40, 0, 12, 0, 40), (64, 5, 16, 0, 64),
                                                   (80, 13, 20, 16, 80), (96, 4, 10, 0, 33),
                                                   (50, 64, 25, 10, 45)])
def test_feature_fps_matches_the_loop(n, c, npoint, start, end):
    rows = _rows(2, n, c, seed=n + c)
    got = cuda_fps.feature_fps(rows, npoint, start, end)
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    for b in range(2):
        want = brute_fps(rows[b].numpy(), npoint, start, end)
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_feature_fps_ties_take_the_lowest_index():
    """Duplicated rows, an all-equal block and a lattice: every step has
    ties, broken to the lowest index."""
    base = _rows(1, 12, 3, seed=4)[0]
    dup = torch.cat([base, base, base])[None]
    same = torch.zeros(1, 20, 6)
    lattice = torch.stack(torch.meshgrid(*[torch.arange(3.0)] * 3, indexing="ij"), -1)
    lattice = torch.cat([lattice.reshape(1, 27, 3), torch.ones(1, 27, 2)], -1)
    for rows, npoint in ((dup, 30), (same, 8), (lattice, 27)):
        got = cuda_fps.feature_fps(rows, npoint)
        np.testing.assert_array_equal(got[0].numpy(), brute_fps(rows[0].numpy(), npoint))
    # every distance 0: the lowest index, 0, at every step
    assert cuda_fps.feature_fps(same, 8)[0].tolist() == [0] * 8


def test_feature_fps_over_xyz_is_k1():
    xyz = _rows(3, 300, 0, seed=9)
    assert torch.equal(cuda_fps.feature_fps(xyz, 64),
                       cuda_fps.furthest_point_sample_plain(xyz, 64))


def test_feature_fps_refuses_bad_ranges():
    rows = _rows(1, 16, 2, seed=0)
    for npoint, start, end in ((20, 0, 16), (4, 8, 8), (2, 0, 17)):
        with pytest.raises(ValueError):
            cuda_fps.feature_fps(rows, npoint, start, end)
    assert cuda_fps.ffps_supported(4096, 67) and cuda_fps.ffps_supported(512, 131)
    assert not cuda_fps.ffps_supported(4096, 1024)


def test_fusion_sampling_concatenates_in_order():
    """SA2's spec (FS over every row) and SA3's (F-FPS over [0, 32), D-FPS
    over the rest), each part the loop's picks of its range."""
    rows = _rows(2, 64, 6, seed=5)
    xyz, feats = rows[..., :3], rows[..., 3:]
    fs = sample_points(xyz, feats, sampler_spec(["FS"], [10], [-1]))
    assert fs.shape == (2, 20)
    split = sample_points(xyz, feats, (Sampler("F-FPS", 8, 32), Sampler("D-FPS", 8)))
    for b in range(2):
        r = rows[b].numpy()
        np.testing.assert_array_equal(fs[b, :10].numpy(), brute_fps(r, 10))
        np.testing.assert_array_equal(fs[b, 10:].numpy(), brute_fps(r[:, :3], 10))
        np.testing.assert_array_equal(split[b, :8].numpy(), brute_fps(r, 8, 0, 32))
        np.testing.assert_array_equal(split[b, 8:].numpy(), brute_fps(r[:, :3], 8, 32, 64))
    with pytest.raises(ValueError):
        Sampler("X-FPS", 4)


@pytest.mark.parametrize("method", ("exact", "blockwise"))
def test_d_fps_sampler_takes_its_method(method):
    """A full-range D-FPS sampler (a PointRCNN stage's spec) gives the
    indices of ``furthest_point_sample`` by its method; 4096 points and 64
    picks stripe blockwise FPS into 4 depth bands."""
    assert _blockwise_stripes(4096, 64) == 4
    xyz = _rows(2, 4096, 0, seed=9)
    got = sample_points(xyz, None, (Sampler("D-FPS", 64, method=method),))
    want = furthest_point_sample(xyz, 64, method=method)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if method == "blockwise":
        assert not torch.equal(got, furthest_point_sample(xyz, 64))


@pytest.mark.parametrize("mode,method", [("D-FPS", "stripes"), ("F-FPS", "blockwise"),
                                         ("FS", "blockwise")])
def test_sampler_refuses_a_method(mode, method):
    """An unknown method, and the blockwise method past D-FPS, are refused
    where the sampler is built."""
    with pytest.raises(ValueError, match="method|blockwise"):
        Sampler(mode, 8, method=method)
