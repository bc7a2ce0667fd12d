"""The plain reference renders what the program's renderer renders, on
the paths the card takes (the ray-shared search over the lattice-packed
table), on the CPU at a small size."""

import pytest
import torch

from reference import render as ref
from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.config import load_config
from point_slam_tpu_torch.models import decoders as D

from conftest import ROOT


def _scene(seed, n_rays=300, holes=0.2):
    g = torch.Generator().manual_seed(seed)
    cap, n = 4096, 3000
    cloud = pc.init_cloud(cap, 32, 3)
    pos = torch.stack([torch.rand(n, generator=g) * 2 - 1,
                       torch.rand(n, generator=g) * 1.5 - 0.75,
                       -2.0 + 0.05 * torch.randn(n, generator=g)], -1)
    rows = cloud.packed.clone()
    rows[:n, :64] = 0.1 * torch.randn((n, 64), generator=g)
    rows[:n, 64:67] = pos
    cloud = cloud._replace(packed=rows, n_points=torch.tensor(n))
    rays_d = torch.stack([torch.rand(n_rays, generator=g) * 0.8 - 0.4,
                          torch.rand(n_rays, generator=g) * 0.6 - 0.3,
                          -torch.ones(n_rays)], -1)
    rays_o = torch.zeros((n_rays, 3))
    depth = 2.0 + 0.02 * torch.randn(n_rays, generator=g)
    depth = torch.where(torch.rand(n_rays, generator=g) < holes, 0.0, depth)
    rq = 0.04 + 0.04 * torch.rand(n_rays, generator=g)
    fill = 0.01 * torch.randn((2, 32), generator=g)
    return cloud, rays_o, rays_d, depth, rq, fill


@pytest.mark.parametrize("near_pcl,rel,color", [
    (False, True, True), (True, False, True), (True, True, False)])
def test_reference_renders_what_the_program_renders(near_pcl, rel, color):
    cfg = load_config(f"{ROOT}/configs/Synthetic/room.yaml",
                      f"{ROOT}/configs/point_slam.yaml")
    cfg["rendering"]["sample_near_pcl"] = near_pcl
    cfg["model"]["encode_rel_pos_in_col"] = rel
    dec = D.init_decoders(cfg, 5)
    cell, table, c = 0.16, 4096, 64
    cloud, ro, rd, depth, rq, fill = _scene(11)
    index = pc.build_index(cloud, cell, table, c, packed_coords=True)
    rc = R.make_render_config(cfg, 0.1, "cpu")._replace(
        ray_knn=True, knn_probes=27)
    valid = torch.ones(ro.shape[0], dtype=torch.bool)
    with torch.no_grad():
        got = R.render_rays(dec, cloud.packed, index, ro, rd, depth, rq,
                            valid, rc, stage_color=color, fill=fill)
    rcfg = {"n_surface": rc.n_surface, "near_end": rc.near_end,
            "near_end_surface": rc.near_end_surface,
            "far_end_surface": rc.far_end_surface,
            "sample_near_pcl": near_pcl, "sigmoid_coef": 0.1,
            "nn_num": 8, "min_nn_num": 2, "weighting": "distance",
            "encode_rel_pos_in_col": rel, "knn_probes": 27,
            "cell_size": cell, "table_size": table, "max_per_cell": c}
    want = ref.render(cloud.packed, dec.state_dict(), ro, rd, depth, rq,
                      valid, fill, rcfg, color)
    assert bool((got[3] == want[3]).all())
    assert bool(want[3].float().mean() > 0.3)     # rays that hit the map
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_table_size_follows_capacity():
    assert ref.table_size(1 << 16, 1 << 17) == 1 << 16
    assert ref.table_size(1 << 16, 1 << 20) == 1 << 17
    assert ref.table_size(4096, 8192) == 4096
