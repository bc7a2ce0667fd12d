"""How far data parallelism moves the mapped features, in both packages.

    python tests/dp_deviation.py

On tests/test_parallel.py's tiny config (32x40, CAP 2^11, 512 mapping rays)
for each mapping variant (plain, BA, exposure, the fused table) over the
frames tests/test_torch_parallel.py maps (three; BA six): the JAX package at dp=2 (a 2-device CPU mesh) against dp=1, and
the port at world size 2 (a gloo group, tests/torch_dist.py) against one
process without a group. Prints, for each, the point counts, whether the
positions are equal, and how many feature entries lie outside
test_parallel.py's tolerance (rtol/atol 2e-3) with the largest difference.

Then how the mapping loop amplifies rounding differences: frame 0 of the
synthetic room at 48x64 (the pretrained, frozen geometry decoder, 30
iterations) mapped by the port's PointSLAM, its features after
iterations 1, 10 and 30 at world size 2 against world size 1, and at
world size 1 with 3 intra-op threads against 1 (no data parallelism: the
CPU's sums in another order). Runs on the CPU in a few minutes.
"""

import os
import sys
import tempfile

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def report(label, p1, p2):
    off = ~np.isclose(p2[:, :64], p1[:, :64], rtol=2e-3, atol=2e-3)
    print(f"{label}: points {len(p1)} / {len(p2)}, positions equal "
          f"{np.array_equal(p1[:, 64:67], p2[:, 64:67])}, feature entries "
          f"outside 2e-3: {off.sum()} of {off.size} ({off.mean():.3%}), "
          f"largest difference {np.abs(p2[:, :64] - p1[:, :64]).max():.4g}",
          flush=True)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from point_slam_tpu.parallel import mesh as pmesh
    from test_parallel import run_frames, tiny_cfg
    import torch_dist as TD

    jax_kw = {"plain": {}, "ba": {"ba": True}, "exposure": {"exposure": True},
              "fused": {}}
    for name, kw in jax_kw.items():
        packed = []
        for dp in (1, 2):
            cfg = tiny_cfg(dp=dp, **kw)
            cfg["mapping"]["pixels"] = 512
            if name == "fused":
                cfg["tpu"].update({"ray_knn": True,
                                   "knn_packed_coords": "fused"})
            pmesh.set_mesh(pmesh.make_mesh(2) if dp == 2 else None)
            try:
                m, _ = run_frames(cfg, n_map=TD.VARIANT_FRAMES[name])
            finally:
                pmesh.set_mesh(None)
            packed.append(np.asarray(m.cloud.packed[:m.n_points_host]))
        report(f"JAX dp=2 vs dp=1, {name}", *packed)

    payload = {"variants": TD.VARIANT_FRAMES, "jobs": ["map_frames"]}
    with tempfile.TemporaryDirectory() as tmp:
        one = TD.spawn(TD.suite, 1, os.path.join(tmp, "one"), payload,
                       group=False)[0]["map_frames"]
        two = TD.spawn(TD.suite, 2, os.path.join(tmp, "two"),
                       payload)[0]["map_frames"]
    for name in TD.VARIANTS:
        report(f"port world size 2 vs 1, {name}", one[name]["packed"],
               two[name]["packed"])

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for label, world, group, threads in (("W=1", 1, False, 1),
                                             ("W=2", 2, True, 1),
                                             ("W=1, 3 threads", 1, False, 3)):
            runs[label] = TD.spawn(
                TD.map0_snapshots, world, os.path.join(tmp, f"w{label}"),
                {"threads": threads, "out": os.path.join(tmp, label)},
                group=group)[0]
    for label in ("W=2", "W=1, 3 threads"):
        for it in (1, 10, 30):
            report(f"map 0 after iteration {it}, {label} vs W=1",
                   runs["W=1"][it], runs[label][it])


if __name__ == "__main__":
    main()
