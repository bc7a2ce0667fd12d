"""The port on the card: the CUDA ray top-k kernels (K1-K3), the fused
row-Adam (K4) and the block top-k of the kNN study (P1-P6) against their
plain PyTorch versions, and the CUDA path of ray_grid_knn against the CPU
path.

These need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
neither JAX nor tests/conftest.py's helpers, so on a card without JAX run
it as

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from point_slam_tpu_torch.ops import adam as tadam
from point_slam_tpu_torch.ops import block_topk as bt
from point_slam_tpu_torch.ops import knn as tk


def cuda_or_skip():
    """The CUDA device, or skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc); this host has none")
    return torch.device("cuda")


def ray_cloud(seed, n_pts=20000, cap=1 << 15, n_rays=1500, ns=5):
    """A random cloud (padding rows at 1e6) and ray-structured samples
    clustered within 0.04*depth around cloud points."""
    rng = np.random.default_rng(seed)
    pts = np.full((cap, 3), 1e6, np.float32)
    pts[:n_pts] = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    centers = pts[rng.integers(0, n_pts, n_rays)]
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth = rng.uniform(1.5, 4.0, n_rays).astype(np.float32)
    z = depth[:, None] * np.linspace(0.98, 1.02, ns).astype(np.float32)
    q = ((centers - dirs * depth[:, None])[:, None, :]
         + dirs[:, None, :] * z[..., None]).astype(np.float32)
    return torch.from_numpy(pts), n_pts, torch.from_numpy(q)


BUILD = {True: tk.build_packed_grid_index, False: tk.build_grid_index,
         "fused": tk.build_fused_grid_index}
NAME = {True: "ray_topk_packed", False: "ray_topk_planes",
        "fused": "ray_topk_fused"}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False, "fused"],
                         ids=["K1", "K2", "K3"])
@pytest.mark.parametrize("n_pts", [20000, 300], ids=["dense", "sparse"])
def test_ray_topk_kernel_equals_plain_on_cuda(packed, n_pts):
    """Keys and ids EQUAL (tolerance 0; ids as int32 bit patterns, since
    K3's winners past the finite candidates read coordinate bits), and the
    launch is counted. The sparse cloud leaves most samples with fewer than
    k candidates."""
    dev = cuda_or_skip()
    pts, n_pts, q = ray_cloud(8, n_pts=n_pts)
    index = BUILD[packed](pts.to(dev), n_pts, 0.16, 1 << 14, 64)
    q = q.to(dev)
    probes, _ = tk._box_probes(q, 0.16, index.table_size, 27)
    qk = (q if packed is False
          else tk._query_lattice(q, index.cell_size)).contiguous()
    lane_mask = 4095 if packed == "fused" else 2047
    name = NAME[packed]
    before = tk.LAUNCHES[name]
    keys, ids = tk.ray_topk(probes, tk.index_planes(index), qk, 8, lane_mask)
    rkeys, rids = tk.ray_topk_reference(probes, tk.index_planes(index), qk,
                                        8, lane_mask)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == before + 1
    assert torch.equal(keys, rkeys)
    assert torch.equal(ids.view(torch.int32), rids.view(torch.int32))
    valid = (keys < 0x7F800000).float().mean()
    assert valid > 0.9 if n_pts == 20000 else valid < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 1500, 5000, 20000])
@pytest.mark.parametrize("n_pts", [20000, 300], ids=["dense", "sparse"])
@pytest.mark.parametrize("p", [27, 36])
@pytest.mark.parametrize("c", [64, 32])
def test_fused_ray_topk_kernel_equals_plain_on_cuda(c, p, n_pts, r):
    """K3 at both built widths and two probe budgets, keys and id bits
    EQUAL to plain; the sparse cloud leaves samples short of k candidates,
    so id lanes win; R=20000 puts several rays on each persistent block."""
    dev = cuda_or_skip()
    pts, n_pts, q = ray_cloud(14, n_pts=n_pts, n_rays=r)
    index = tk.build_fused_grid_index(pts.to(dev), n_pts, 0.16, 1 << 14, c)
    q = q.to(dev)
    probes, _ = tk._box_probes(q, 0.16, index.table_size, p)
    qk = tk._query_lattice(q, index.cell_size).contiguous()
    lane_mask = tk._lane_mask(p * 2 * c)
    before = tk.LAUNCHES["ray_topk_fused"]
    keys, ids = tk.ray_topk(probes, (index.plane,), qk, 8, lane_mask)
    rkeys, rids = tk.ray_topk_reference(probes, (index.plane,), qk, 8,
                                        lane_mask)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["ray_topk_fused"] == before + 1
    assert torch.equal(keys, rkeys)
    assert torch.equal(ids.view(torch.int32), rids.view(torch.int32))
    if r > 1:          # one ray's five samples say little of the cloud
        short = (keys >= 0x7F800000).float().mean()
        assert short > 0.3 if n_pts == 300 else short < 0.1


@pytest.mark.cuda
def test_fused_ray_topk_refuses_unbuilt_widths_on_cuda():
    """A CUDA plane whose C the kernel is not built for raises, naming the
    widths it has; nothing falls back to the plain version."""
    dev = cuda_or_skip()
    probes = torch.zeros((4, 27), dtype=torch.int32, device=dev)
    q = torch.zeros((4, 5, 3), device=dev)
    before = dict(tk.LAUNCHES)
    for c in (16, 48, 96):
        plane = torch.full((9, 2 * c), -1, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match=r"C in \(32, 64\), not C="):
            tk.ray_topk(probes, (plane,), q, 8, tk._lane_mask(27 * 2 * c))
    assert tk.LAUNCHES == before
    plane = torch.full((9, 128), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32, int32, float32"):
        tk.ray_topk(probes.float(), (plane,), q, 8, 4095)


def adam_case(rng, n, w, dev):
    p, g, m = (torch.from_numpy(rng.standard_normal((n, w)).astype(
        np.float32)).to(dev) for _ in range(3))
    v = torch.from_numpy(np.abs(rng.standard_normal((n, w))).astype(
        np.float32)).to(dev) * 0.01
    mask = torch.from_numpy(rng.random(n) < 0.7).to(dev).float()
    return p, g, m, v, mask


def assert_adam_equal(p, g, m, v, t_row, lr_row, mask):
    """The kernel, in place, EQUAL to update_rows_reference (0 ulp)."""
    want_p, want = tadam.update_rows_reference(p, g, {"m": m, "v": v}, t_row,
                                               lr_row, mask)
    before = tadam.LAUNCHES["row_adam"]
    buf = {"m": m.clone(), "v": v.clone()}
    got_p, got = tadam.update_rows(p.clone(), g, buf, t_row, lr_row, mask)
    torch.cuda.synchronize()
    assert tadam.LAUNCHES["row_adam"] == before + 1
    assert got["m"] is buf["m"]                # in place
    assert torch.equal(got_p, want_p)
    assert torch.equal(got["m"], want["m"]) and torch.equal(got["v"],
                                                            want["v"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 18006])
def test_row_adam_kernel_on_a_live_prefix_equals_plain_on_cuda(n):
    """K4 on the first n rows of a (2^15, 72) buffer, as the mapper hands
    it the live prefix: n = 1, and row counts whose n*72/4 vectors are no
    multiple of a block's 512; the rows past n are untouched."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(21)
    p, g, m, v, mask = adam_case(rng, 1 << 15, 72, dev)
    t_row = torch.from_numpy(rng.integers(1, 40, 72).astype(np.float32)).to(
        dev)
    lr_row = torch.from_numpy(rng.uniform(1e-4, 3e-2, 72).astype(
        np.float32)).to(dev)
    assert_adam_equal(p[:n], g[:n], m[:n], v[:n], t_row, lr_row, mask[:n])
    full = p.clone()
    tadam.update_rows(full[:n], g[:n], {"m": m[:n].clone(),
                                        "v": v[:n].clone()},
                      t_row, lr_row, mask[:n])
    torch.cuda.synchronize()
    assert torch.equal(full[n:], p[n:])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 300, "1..4000"])
def test_row_adam_bias_corrections_in_the_kernel_on_cuda(t):
    """The kernel's own c1 = 1 - b1^t, c2 = 1 - b2^t give PyTorch's bits:
    at t = 1 and t = 300 in every column, at every t from 1 to 4000 (one
    column each), and with t and lr given as numbers."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(22)
    w = 4000 if t == "1..4000" else 72
    p, g, m, v, mask = adam_case(rng, 64, w, dev)
    t_row = (torch.arange(1, w + 1, dtype=torch.float32, device=dev)
             if t == "1..4000" else torch.full((w,), float(t), device=dev))
    lr_row = torch.full((w,), 0.01, device=dev)
    assert_adam_equal(p, g, m, v, t_row, lr_row, mask)
    if t != "1..4000":
        assert_adam_equal(p, g, m, v, float(t), 0.01, mask)


@pytest.mark.cuda
def test_row_adam_kernel_equals_plain_on_cuda():
    """p, m and v EQUAL to update_rows_reference (0 ulp), in place, with a
    per-row mask and per-column step counts and learning rates."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(11)
    n, w = 1 << 15, 72
    p, g, m = (torch.from_numpy(rng.standard_normal((n, w)).astype(
        np.float32)).to(dev) for _ in range(3))
    v = torch.from_numpy(np.abs(rng.standard_normal((n, w))).astype(
        np.float32)).to(dev) * 0.01
    mask = torch.from_numpy(rng.random(n) < 0.7).to(dev).float()
    t_row = torch.from_numpy(rng.integers(1, 40, w).astype(np.float32)).to(dev)
    lr_row = torch.from_numpy(rng.uniform(1e-4, 3e-2, w).astype(
        np.float32)).to(dev)
    want_p, want = tadam.update_rows_reference(p, g, {"m": m, "v": v}, t_row,
                                               lr_row, mask)
    before = tadam.LAUNCHES["row_adam"]
    buf = {"m": m.clone(), "v": v.clone()}
    got_p, got = tadam.update_rows(p.clone(), g, buf, t_row, lr_row, mask)
    torch.cuda.synchronize()
    assert tadam.LAUNCHES["row_adam"] == before + 1
    assert got["m"] is buf["m"]                # in place
    assert torch.equal(got_p, want_p)
    assert torch.equal(got["m"], want["m"]) and torch.equal(got["v"],
                                                            want["v"])
    with pytest.raises(ValueError, match="multiple of 4"):
        tadam.update_rows(p[:, :70].contiguous(), g[:, :70].contiguous(),
                          {"m": m[:, :70].contiguous(),
                           "v": v[:, :70].contiguous()}, t_row[:70],
                          lr_row[:70], mask)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False, "fused"],
                         ids=["K1", "K2", "K3"])
def test_ray_grid_knn_on_cuda_equals_the_cpu_path(packed):
    """The same cloud indexed and queried on the card (kernel) and on the
    CPU (plain version) gives the same index and the same neighbours."""
    dev = cuda_or_skip()
    pts, n_pts, q = ray_cloud(9)
    cpu = BUILD[packed](pts, n_pts, 0.16, 1 << 14, 64)
    gpu = BUILD[packed](pts.to(dev), n_pts, 0.16, 1 << 14, 64)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())
    want = tk.ray_grid_knn(cpu, q, k=8, probes=27)
    got = tk.ray_grid_knn(gpu, q.to(dev), k=8, probes=27)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())


def gathered_block(seed, layout, n_planes, p, c, fill, dev, r=1000, ns=5):
    """A candidate block in ``layout`` (a share ``fill`` of the slots
    filled, the rest +inf as the table's empty slots; ids +inf there) and
    q (R, ns, 3), on ``dev``."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (r, 1, 3)) + rng.normal(0, 0.02, (r, ns, 3))
    pos = q[:, :1, None, :] + rng.normal(0, 0.1, (r, p, c, 3))
    ids = rng.integers(0, 1 << 20, (r, p, c)).astype(np.float64)
    empty = rng.random((r, p, c)) >= fill
    pos[empty] = np.inf
    ids[empty] = np.inf
    planes = [torch.from_numpy(pos[..., a].astype(np.float32)).to(dev)
              for a in range(3)]
    planes.append(torch.from_numpy(ids.astype(np.float32)).to(dev))
    planes = planes[:n_planes]
    flat = [pl_.reshape(r, p * c) for pl_ in planes]
    cand = {"planes": flat, "row": torch.cat(flat, 1),
            "component": torch.stack(flat),
            "quad": torch.stack(planes, 2).reshape(r, p * n_planes * c)
            }[layout]
    q = torch.from_numpy(q.astype(np.float32)).to(dev)
    return bt.layout_views(cand, layout, r, p, c, n_planes), q


@pytest.mark.cuda
@pytest.mark.parametrize("p,c,lane_mask", [(36, 64, 4095), (40, 64, 8191),
                                           (64, 64, 8191)],
                         ids=["P36", "P40-mask8191", "PC4096"])
@pytest.mark.parametrize("fill", [0.6, 0.001], ids=["dense", "sparse"])
@pytest.mark.parametrize("n_planes", [4, 3], ids=["ids", "keys"])
@pytest.mark.parametrize("layout", ["planes", "row", "component", "quad"])
def test_block_topk_kernel_equals_plain_on_cuda(layout, n_planes, fill, p,
                                                c, lane_mask):
    """Keys and ids EQUAL (tolerance 0; ids as int32 bit patterns, +inf
    for empty winners), for every layout's strides, with and without the
    id view, up to P*C = 4096 lanes (48 KB of shared memory); the launch
    is counted."""
    dev = cuda_or_skip()
    views, q = gathered_block(12, layout, n_planes, p, c, fill, dev)
    before = bt.LAUNCHES["block_topk"]
    keys, ids = bt.block_topk(views, q.unbind(-1), 8, lane_mask)
    want_keys, want_ids = bt.block_topk_reference(views, q, 8, lane_mask)
    torch.cuda.synchronize()
    assert bt.LAUNCHES["block_topk"] == before + 1
    assert torch.equal(keys, want_keys)
    if n_planes == 3:
        assert ids is None and want_ids is None
    else:
        assert torch.equal(ids.view(torch.int32), want_ids.view(torch.int32))
    short = (keys >= 0x7F800000).float().mean()
    assert short > 0.3 if fill < 0.5 else short == 0


@pytest.mark.cuda
def test_block_topk_refuses_bad_inputs_on_cuda():
    dev = cuda_or_skip()
    views, q = gathered_block(13, "row", 4, 36, 64, 0.5, dev, r=64)
    with pytest.raises(ValueError, match="k<=8"):
        bt.block_topk(views, q, 9, 4095)
    with pytest.raises(ValueError, match="float32"):
        bt.block_topk(tuple(v.double() for v in views), q, 8, 4095)
    # a view whose slots are not contiguous (probe and slot axes swapped)
    swapped = tuple(v.transpose(1, 2) for v in views)
    with pytest.raises(ValueError, match="slot stride 1"):
        bt.block_topk(swapped, q, 8, 4095)
    with pytest.raises(ValueError, match="lane_mask"):
        bt.block_topk(views, q, 8, 2047)


@pytest.mark.cuda
def test_ray_topk_refuses_bad_inputs_on_cuda():
    dev = cuda_or_skip()
    probes = torch.zeros((4, 27), dtype=torch.int32, device=dev)
    planes = (torch.zeros((9, 64), dtype=torch.int32, device=dev),
              torch.zeros((9, 64), device=dev))
    q = torch.zeros((4, 5, 3), device=dev)
    with pytest.raises(ValueError, match="k<=8"):
        tk.ray_topk(probes, planes, q, 9, 2047)
    with pytest.raises(ValueError, match="dtypes"):
        tk.ray_topk(probes.float(), planes, q, 8, 2047)
