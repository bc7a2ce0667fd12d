"""The port on the card: the CUDA ray top-k kernels (K1-K3), the fused
row-Adam (K4), the multi-tensor Adam (multi_adam) and the block top-k of
the kNN study (P1-P6) against their plain PyTorch versions, and the CUDA
path of ray_grid_knn against the CPU path.

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


def full_cell_cloud(seed, n_rays, ns=5, n_full=100, n_rest=300,
                    cap=1 << 15):
    """A sparse cloud with ``n_full`` points in the cell [0, 0.16)^3 (more
    than C of either built width) and rays whose samples all lie in that
    cell, so each ray's probe 0 is a full bucket: no empty slot there, and
    its 0.16-cell neighbourhood holds the points past C that stay."""
    rng = np.random.default_rng(seed)
    pts = np.full((cap, 3), 1e6, np.float32)
    pts[:n_rest] = rng.uniform(-2, 2, (n_rest, 3))
    pts[n_rest:n_rest + n_full] = rng.uniform(0.01, 0.15, (n_full, 3))
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.linspace(-0.03, 0.03, ns).astype(np.float32)
    q = (0.08 + rng.uniform(-0.02, 0.02, (n_rays, 1, 3))
         + dirs[:, None, :] * z[None, :, None]).astype(np.float32)
    return torch.from_numpy(pts), n_rest + n_full, torch.from_numpy(q)


BUILD = {"K1": tk.build_packed_grid_index, "K2": tk.build_grid_index,
         "K3": tk.build_fused_grid_index}
NAME = {"K1": "ray_topk_packed", "K2": "ray_topk_planes",
        "K3": "ray_topk_fused"}


def query_of(kernel, q, index):
    """The queries the kernel takes: metric (K2) or lattice (K1, K3)."""
    return (q if kernel == "K2"
            else tk._query_lattice(q, index.cell_size)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 1500, 5000, 20000])
@pytest.mark.parametrize("cloud", ["dense", "sparse", "full"])
@pytest.mark.parametrize("p", [27, 36])
@pytest.mark.parametrize("c", [64, 32, 4, 16, 48, 96])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_ray_topk_kernel_equals_plain_on_cuda(kernel, c, p, cloud, r):
    """Each layout at both built widths, at four widths of the generic
    instantiation (4: a row of one 16-byte chunk and C < 2k; 16; 48 and
    96, not powers of two) and two probe budgets: keys and ids EQUAL to
    the plain version (tolerance 0; ids as int32 bit patterns, since K3's
    winners past the finite candidates read coordinate bits), and the
    launch is counted. The sparse cloud leaves most samples with fewer
    than k points, so empty lanes (and K3's id lanes) win; "full" fills
    each ray's probe 0, so that bucket has no empty lane (with C >= 2k a
    sample that sees a full probe 0 has k points, so no empty lane wins
    there; with C = 4 the +inf winners lie past probe 0); R=20000 puts
    several rays on each persistent block."""
    dev = cuda_or_skip()
    if cloud == "full":
        pts, n_pts, q = full_cell_cloud(15, r)
    else:
        pts, n_pts, q = ray_cloud(14, n_pts=20000 if cloud == "dense"
                                  else 300, n_rays=r)
    index = BUILD[kernel](pts.to(dev), n_pts, 0.16, 1 << 14, c)
    q = q.to(dev)
    probes, _ = tk._box_probes(q, 0.16, index.table_size, p)
    qk = query_of(kernel, q, index)
    planes = tk.index_planes(index)
    lane_mask = tk._lane_mask(p * planes[0].shape[1])
    name = NAME[kernel]
    before = tk.LAUNCHES[name]
    keys, ids = tk.ray_topk(probes, planes, qk, 8, lane_mask)
    rkeys, rids = tk.ray_topk_reference(probes, planes, qk, 8, lane_mask)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == before + 1
    assert torch.equal(keys, rkeys)
    assert torch.equal(ids.view(torch.int32), rids.view(torch.int32))
    short = (keys >= 0x7F800000).float().mean()
    if cloud == "full":
        assert (index.counts[probes[:, 0].long()] > c).all()
        assert short == 0 if c >= 16 else short > 0
    elif r > 1:        # one ray's five samples say little of the cloud
        assert short > 0.3 if cloud == "sparse" else short < 0.1


def planes_of(kernel, c, dev, rows=9, view=None):
    """Empty planes of ``kernel``'s layout at width C, each made by
    ``view(shape, fill, dtype)`` (default: a fresh contiguous tensor)."""
    view = view or (lambda shape, fill, dt: torch.full(shape, fill, dtype=dt,
                                                       device=dev))
    inf = float("inf")
    specs = {"K1": [((rows, c), -1, torch.int32),
                    ((rows, c), inf, torch.float32)],
             "K2": [((rows, c), inf, torch.float32)] * 4,
             "K3": [((rows, 2 * c), -1, torch.int32)]}[kernel]
    return tuple(view(*spec) for spec in specs)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_ray_topk_refuses_blocks_past_shared_memory_on_cuda(kernel):
    """Every C whose block fits launches (C = 128 at P = 27 EQUAL to the
    plain version, its shared memory the one check_ray_topk_shape counts);
    a block past the card's shared memory (C = 128 at P = 64; K2, which
    compacts a lane a point, at C = 160) raises naming the bytes, before
    any launch; nothing falls back to the plain version."""
    dev = cuda_or_skip()
    name = NAME[kernel]
    pts, n_pts, q = ray_cloud(16, n_rays=500)
    index = BUILD[kernel](pts.to(dev), n_pts, 0.16, 1 << 14, 128)
    q = q.to(dev)
    probes, _ = tk._box_probes(q, 0.16, index.table_size, 27)
    planes = tk.index_planes(index)
    qk = query_of(kernel, q, index)
    mask = tk._lane_mask(27 * planes[0].shape[1])
    keys, ids = tk.ray_topk(probes, planes, qk, 8, mask)
    rkeys, rids = tk.ray_topk_reference(probes, planes, qk, 8, mask)
    assert torch.equal(keys, rkeys)
    assert torch.equal(ids.view(torch.int32), rids.view(torch.int32))
    per_sm, smem = tk.ray_topk_occupancy(planes, 27, 5)
    assert per_sm >= 1 and smem == tk.ray_topk_smem_bytes(name, 27, 128, 5)
    c_out = 160 if kernel == "K2" else 128
    probes = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    q = torch.zeros((4, 5, 3), device=dev)
    before = dict(tk.LAUNCHES)
    planes = planes_of(kernel, c_out, dev)
    need = tk.ray_topk_smem_bytes(name, 64, c_out, 5)
    with pytest.raises(ValueError, match=f"needs {need} bytes"):
        tk.ray_topk(probes, planes, q, 8,
                    tk._lane_mask(64 * planes[0].shape[1]))
    assert tk.ray_topk_occupancy(planes, 64, 5) == (0, need)
    assert tk.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_ray_topk_refuses_bad_inputs_on_cuda(kernel):
    """k > 8, a wrong dtype, planes of different shapes, a plane that is
    not 16-byte aligned and one that is a non-contiguous view all raise
    before any launch."""
    dev = cuda_or_skip()
    probes = torch.zeros((4, 27), dtype=torch.int32, device=dev)
    q = torch.zeros((4, 5, 3), device=dev)
    planes = planes_of(kernel, 64, dev)
    mask = tk._lane_mask(27 * planes[0].shape[1])
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="k<=8"):
        tk.ray_topk(probes, planes, q, 9, mask)
    with pytest.raises(ValueError, match="dtypes"):
        tk.ray_topk(probes.float(), planes, q, 8, mask)
    with pytest.raises(ValueError, match="lane_mask"):
        tk.ray_topk(probes, planes, q, 8, mask // 2)
    if len(planes) > 1:
        with pytest.raises(ValueError, match="shapes"):
            tk.ray_topk(probes, (*planes[:-1], planes[-1][:8]), q, 8, mask)
    # one word past a 16-byte boundary, still contiguous
    shifted = planes_of(kernel, 64, dev, view=lambda shape, fill, dt: (
        torch.full((shape[0] * shape[1] + 1,), fill, dtype=dt,
                   device=dev)[1:].view(shape)))
    assert all(pl_.is_contiguous() for pl_ in shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.ray_topk(probes, shifted, q, 8, mask)
    # rows of a wider tensor: the row stride is not the plane's width
    strided = planes_of(kernel, 64, dev, view=lambda shape, fill, dt: (
        torch.full((shape[0], 2 * shape[1]), fill, dtype=dt,
                   device=dev)[:, :shape[1]]))
    with pytest.raises(ValueError, match="contiguous"):
        tk.ray_topk(probes, strided, q, 8, mask)
    assert tk.LAUNCHES == before


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


def adam_leaves(rng, dev, n=5000, live=3000, f=10, extra=0):
    """The mapper's step at a small size: an (n, 72) leaf with (72,) step
    counts and learning rates whose rows past ``live`` have zero gradient
    and moments; decoder-shaped tensors, some with element counts no
    multiple of 4, with numbers for t and lr; an (f, 7) camera leaf with
    learning rate 0; ``extra`` more small tensors."""
    shapes = ([(n, 72), (128, 52), (128,), (3, 10), (3,), (3, 128),
               (32, 128), (7, 3), (f, 7)]
              + [(int(rng.integers(1, 70)),) for _ in range(extra)])

    def draw(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev)
    params = [draw(s) for s in shapes]
    grads = [draw(s) for s in shapes]
    m = [draw(s, 0.1) for s in shapes]
    v = [draw(s, 0.01).abs() for s in shapes]
    for x in (grads[0], m[0], v[0]):
        x[live:] = 0.0
    t = [torch.from_numpy(rng.integers(1, 40, 72).astype(np.float32)).to(
        dev)] + [float(rng.integers(1, 300)) for _ in shapes[1:]]
    lr = [torch.from_numpy(rng.uniform(1e-4, 3e-2, 72).astype(
        np.float32)).to(dev)] + [float(rng.uniform(1e-4, 1e-2))
                                 for _ in shapes[1:]]
    lr[len(shapes) - extra - 1] = 0.0      # the cameras
    return params, grads, m, v, t, lr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one table", "live rows", "two tables"])
def test_multi_adam_in_place_equals_update_on_cuda(case):
    """update(..., in_place=True) launches multi_adam once (per table of
    tensors) and writes p, m and v in place, EQUAL (0 ulp) to update(...);
    the leaf's zero-gradient rows come back bit for bit, stepped
    (rows None) or left out (rows = the live prefix)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(23)
    max_tensors, _ = tadam._multi_adam_limits()
    params, grads, m, v, t, lr = adam_leaves(
        rng, dev, extra=max_tensors if case == "two tables" else 0)
    want_p, want = tadam.update(params, grads, {"m": m, "v": v}, t, lr)
    p_in, m_in, v_in = ([x.clone() for x in xs] for xs in (params, m, v))
    before = tadam.LAUNCHES["multi_adam"]
    got_p, got = tadam.update(
        p_in, grads, {"m": m_in, "v": v_in}, t, lr, in_place=True,
        rows=[3000] + [None] * (len(params) - 1) if case == "live rows"
        else None)
    torch.cuda.synchronize()
    assert tadam.LAUNCHES["multi_adam"] == before + -(-len(params)
                                                       // max_tensors)
    assert len(params) <= max_tensors or case == "two tables"
    for got_xs, given, want_xs in ((got_p, p_in, want_p),
                                   (got["m"], m_in, want["m"]),
                                   (got["v"], v_in, want["v"])):
        assert all(a is b for a, b in zip(got_xs, given))
        for a, b in zip(given, want_xs):
            assert torch.equal(a, b)
    assert torch.equal(p_in[0][3000:], params[0][3000:])
    assert torch.equal(p_in[8], params[8])             # learning rate 0
    assert not torch.equal(p_in[1], params[1])


@pytest.mark.cuda
def test_multi_adam_refuses_misaligned_tensors_on_cuda():
    """A tensor whose storage starts off a 16-byte boundary is refused
    before any launch."""
    dev = cuda_or_skip()
    p = torch.zeros(129, device=dev)[1:].view(4, 32)    # 4 bytes off
    before = tadam.LAUNCHES["multi_adam"]
    with pytest.raises(ValueError, match="aligned"):
        tadam.update([p], [torch.ones(4, 32, device=dev)],
                     {"m": [torch.zeros(4, 32, device=dev)],
                      "v": [torch.zeros(4, 32, device=dev)]}, 1.0, 1e-3,
                     in_place=True)
    assert tadam.LAUNCHES["multi_adam"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_ray_grid_knn_on_cuda_equals_the_cpu_path(kernel):
    """The same cloud indexed and queried on the card (kernel) and on the
    CPU (plain version) gives the same index and the same neighbours."""
    dev = cuda_or_skip()
    pts, n_pts, q = ray_cloud(9)
    cpu = BUILD[kernel](pts, n_pts, 0.16, 1 << 14, 64)
    gpu = BUILD[kernel](pts.to(dev), n_pts, 0.16, 1 << 14, 64)
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
def test_host_keyframe_ring_window_equals_the_device_ring_on_cuda():
    """The host ring's pinned staging buffer and its asynchronous upload
    give the device ring's window, bit for bit, over consecutive gathers
    (the second waits for the first copy before refilling the buffer)."""
    dev = cuda_or_skip()
    import os
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.mapper import KeyframeStore
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "Synthetic", "room.yaml"),
                      os.path.join(root, "configs", "point_slam.yaml"))
    stores = []
    for host in (False, True):
        cfg["cuda"]["keyframe_host_ring"] = host
        stores.append(KeyframeStore(cfg, 120, 160, 40, 2, dev))
    g = torch.Generator(device=dev).manual_seed(0)
    for k in range(6):
        color = torch.rand(120, 160, 3, generator=g, device=dev)
        depth = 5 * torch.rand(120, 160, generator=g, device=dev)
        for s in stores:
            s.append(color, depth, np.eye(4) + k)
    assert stores[1].host_mode and not stores[0].host_mode
    for sel in ([0, 2], [5, 4, 3, 1], [1]):
        for a, b in zip(stores[0].gather_window(sel, 6),
                        stores[1].gather_window(sel, 6)):
            assert a.device.type == b.device.type == "cuda"
            assert torch.equal(a, b)
    assert stores[1]._staging.is_pinned()


@pytest.mark.cuda
def test_bf16_view_on_cuda_equals_the_cpu():
    """encode_render's bits on the card equal the host's; the gather's
    backward through the view (bf16 atomics on the card, in no fixed
    order) lands within bf16 rounding of the host's f32 gradient."""
    from point_slam_tpu_torch import pointcloud as pc
    dev = cuda_or_skip()
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(4096, pc.PACK_W)) * 4)
                         .astype(np.float32))
    x[:16, pc.POS_SL] = 1e6
    assert torch.equal(pc.encode_render(x.to(dev)).view(torch.int16).cpu(),
                       pc.encode_render(x).view(torch.int16))
    idx = torch.from_numpy(rng.integers(0, 4096, (20000, 8)))
    grads = []
    for d in (dev, torch.device("cpu")):
        p = x.to(d).requires_grad_(True)
        rows = pc.encode_render(p)[idx.to(d)]
        (pc.neighbor_geo(rows) * 0.5 + pc.neighbor_col(rows)).sum().backward()
        grads.append(p.grad.cpu())
    assert grads[0].dtype == torch.float32
    assert torch.equal(grads[0][:, pc.POS_SL.start:],
                       torch.zeros_like(grads[0][:, pc.POS_SL.start:]))
    torch.testing.assert_close(grads[0], grads[1], rtol=2 ** -7, atol=0.5)


@pytest.mark.cuda
def test_mlp_precision_default_runs_the_blocks_in_tf32_on_cuda():
    """'default': the MLP-block linears in TF32 forward and backward
    (different from IEEE f32, within 1e-2 of max |out|), the switch off
    again after; 'highest' bit-equal to no setting."""
    from point_slam_tpu_torch.models import decoders as D
    dev = cuda_or_skip()
    dec = D.Decoders({"model": {"c_dim": 32}},
                     generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    p = 2 * torch.rand((5000, 3), generator=g, device=dev) - 1
    c = 0.1 * torch.randn((5000, 32), generator=g, device=dev)
    out = {}
    for prec in (None, "highest", "default"):
        dec.zero_grad()
        x = c.clone().requires_grad_(True)
        y = dec.col(p, x, precision=prec)
        y.square().sum().backward()
        out[prec] = (y.detach(), x.grad, dec.col.pts_linears[0].weight.grad
                     .clone())
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert all(torch.equal(a, b) for a, b in zip(out[None], out["highest"]))
    for a, b in zip(out["default"], out[None]):
        assert not torch.equal(a, b)
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-2


@pytest.mark.cuda
def test_data_parallel_world_size_1_under_nccl_on_cuda(tmp_path):
    """An NCCL group of one: the helpers reduce and gather CUDA tensors as
    the identity, and mapping tests/test_parallel.py's tiny config over
    three frames (GT poses) takes the collectives and tracks the run
    without a group: same points and positions, features within 2e-3 in
    all but 1% of the entries (the CUDA scatter-adds sum in a varying
    order, which Adam turns into learning-rate steps on noise-level
    gradients; see tests/test_torch_parallel.py)."""
    import datetime
    import torch.distributed as dist
    import torch_dist as TD
    from point_slam_tpu_torch.common import image
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.mapper import Mapper
    from point_slam_tpu_torch.models import decoders as D
    from point_slam_tpu_torch.parallel import dist as pdist
    dev = cuda_or_skip()

    def mapped():
        cfg = TD.tiny_cfg(1)
        ds = get_dataset(cfg)
        m = Mapper(cfg, D.init_decoders(cfg, 0, dev), len(ds),
                   np.random.default_rng(0), dev)
        sent = pdist.SENT["all_reduce"]
        for i in range(3):
            _, color, depth, c2w = ds[i]
            m.map_frame(i, color, depth, c2w, c2w)
        return (pdist.SENT["all_reduce"] > sent,
                m.cloud.packed[:m.n_points_host].cpu().numpy())

    torch.cuda.set_device(0)
    plain = mapped()
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        x = torch.randn(1000, device=dev)
        mask = x > 0
        y = x.clone()
        pdist.all_reduce_flat([y])
        assert torch.equal(y, x)
        assert torch.equal(pdist.all_gather_cat(x), x)
        assert torch.equal(pdist.masked_median(x, mask),
                           image.masked_median(x, mask))
        assert torch.equal(pdist.masked_mean(x, mask),
                           image.masked_mean(x, mask))
        grouped = mapped()
    finally:
        dist.destroy_process_group()
    assert (plain[0], grouped[0]) == (False, True)
    a, b = plain[1], grouped[1]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, 64:67], b[:, 64:67])
    off = ~np.isclose(b[:, :64], a[:, :64], rtol=2e-3, atol=2e-3)
    assert off.mean() <= 0.01, off.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("n_pts,cap", [(300, 512), (3, 64), (20000, 1 << 15)])
def test_brute_knn_on_cuda_equals_the_cpu(n_pts, cap):
    dev = cuda_or_skip()
    rng = np.random.default_rng(n_pts)
    pts = np.full((cap, 3), 1e6, np.float32)
    pts[:n_pts] = rng.uniform(-2, 2, (n_pts, 3))
    q = torch.from_numpy(rng.uniform(-2, 2, (256, 3)).astype(np.float32))
    p = torch.from_numpy(pts)
    want = tk.brute_knn(p, n_pts, q, k=8, tile=1024)
    got = tk.brute_knn(p.to(dev), n_pts, q.to(dev), k=8, tile=1024)
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=0)
