"""The ray-sampling rung, split: where a mapping iteration's sampling goes.

    python -m point_slam_tpu_torch.profiling.sample_stages
        [--device cuda|cpu] [--frames 12] [--height 680] [--width 1200]
        [--rays 5000] [--iters 30]

At the bench's shapes (a 12-frame 680x1200 window of random colour, depth
and r_query; 5000 rays) it times, with CUDA events over ``--iters`` calls
and with the profiler's device time:

  s1 full      ``mapper._sample_window_rays`` as shipped
  s2 nomedian  the same with the median/max inside-filter replaced by a
               constant
  s3 sortmed   the sort-based masked median of 5000 depths alone
  s4 shipped   ``common/image.masked_median`` alone

The TPU package's shipped median is a 32-step radix select, checked
there against a full-sort median (s3). The port's shipped
``masked_median`` is itself the sort (``torch.sort``, the lower middle),
so s3 and s4 run the same algorithm here and time it twice. On the host it
runs each once and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch.common import image
from point_slam_tpu_torch.profiling import workload as W


def static(frames: int, h: int, w: int, rays: int) -> M.MapperStatic:
    """A MapperStatic for _sample_window_rays at these shapes."""
    return M.MapperStatic(
        h=h, w=w, fx=600.0, fy=600.0, cx=(w - 1) / 2, cy=(h - 1) / 2,
        r_max=rays, f_max=frames, w_color_loss=0.1, frustum_edge=-4.0,
        fix_geo_decoder=True, n_add=3, near_end_surface_pc=0.98,
        far_end_surface_pc=1.02, add_max=1, grad_max=1, grad_top=1)


def sample_nomedian(ms, window, i, j):
    """s2: the window's pixel gathers, the inside-filter a constant
    (depth <= 60)."""
    color, depth, rq = window
    slot = torch.arange(ms.r_max, device=depth.device) // max(
        ms.r_max // ms.f_max, 1)
    ok = slot < ms.f_max
    slot = torch.clamp(slot, max=ms.f_max - 1)
    col, dep, r = color[slot, j, i], depth[slot, j, i], rq[slot, j, i]
    ok &= (dep > 0) & (dep <= 60.0)
    return col, dep, r, ok


def run(dev, frames: int = 12, h: int = 680, w: int = 1200,
        rays: int = 5000, iters: int = 30):
    g = torch.Generator(device=dev).manual_seed(0)
    window = (torch.rand((frames, h, w, 3), generator=g, device=dev),
              0.5 + 5.5 * torch.rand((frames, h, w), generator=g, device=dev),
              0.02 + 0.14 * torch.rand((frames, h, w), generator=g,
                                       device=dev))
    depths = 0.5 + 5.5 * torch.rand(rays, generator=g, device=dev)
    ms = static(frames, h, w, rays)

    def pix():
        return (torch.randint(0, w, (rays,), generator=g, device=dev),
                torch.randint(0, h, (rays,), generator=g, device=dev))

    def jitter():
        return depths + 1e-3 * torch.randn(rays, generator=g, device=dev)

    def median():
        d = jitter()
        return image.masked_median(d, d > 0)

    lines = {
        "s1 full sample": lambda: M._sample_window_rays(
            ms, window, frames, rays // frames, *pix()),
        "s2 no median/max": lambda: sample_nomedian(ms, window, *pix()),
        "s3 sort median 5k": median,
        "s4 shipped masked_median": median,
    }
    out = {}
    for name, fn in lines.items():
        out[name] = {"ms": W.wall_ms(fn, dev, iters),
                     "device_ms": W.busy_ms(fn, dev, iters)}
        print(f"[sample] {name:<26} {W.shown(out[name]['ms'])} (device "
              f"{W.shown(out[name]['device_ms'])})", flush=True)
    t = [out[n]["ms"] for n in lines]
    if None not in t:
        print(f"[sample] median+max share {t[0] - t[1]:.4f} ms | sort "
              f"median alone {t[2]:.4f} | shipped median alone {t[3]:.4f} "
              "(the same sort)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--rays", type=int, default=5000)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "sample_stages")
    out = run(dev, args.frames, args.height, args.width, args.rays,
              args.iters)
    W.save_json("sample_stages_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
