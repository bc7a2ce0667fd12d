"""The port on the card: the CUDA ray top-k kernels (K1-K3) and the fused
row-Adam (K4) against their plain PyTorch versions, and the CUDA path of
ray_grid_knn against the CPU path.

These need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
neither JAX nor tests/conftest.py's helpers, so on a card without JAX run
it as

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from point_slam_tpu_torch.ops import adam as tadam
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
