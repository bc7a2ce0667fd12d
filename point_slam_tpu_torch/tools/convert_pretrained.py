"""Convert the NICE-SLAM pretrained middle/fine decoder checkpoint to npz.

The port's copy of ``point_slam_tpu.tools.convert_pretrained``: the
reference warm-starts its geometry decoder from pretrained/middle_fine.pt
(src/Point_SLAM.py:143-164). This tool extracts that decoder's arrays (the
checkpoint's 'model' keys under 'decoder.coarse.', the prefix the reference
stores it under, minus that prefix) into the npz layout that
``models.decoders.load_pretrained_geo`` reads: torch Linear (out, in)
weights, ``embedder._B``.

    python -m point_slam_tpu_torch.tools.convert_pretrained \\
        pretrained/middle_fine.pt pretrained/middle_fine.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def convert(src: str, dst: str) -> int:
    """Write ``src``'s middle-decoder arrays to ``dst``; their count."""
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    out = {}
    for key, val in ckpt["model"].items():
        if "decoder" in key and "encoder" not in key and "coarse" in key:
            out[key[len("decoder.coarse."):]] = np.asarray(val.numpy())
    np.savez(dst, **out)
    return len(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src")
    parser.add_argument("dst")
    args = parser.parse_args(argv)
    n = convert(args.src, args.dst)
    print(f"wrote {n} arrays to {args.dst}")


if __name__ == "__main__":
    main()
