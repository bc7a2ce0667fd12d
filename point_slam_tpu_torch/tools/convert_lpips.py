"""Export the AlexNet-LPIPS weights to the npz that ``utils/metrics.lpips``
reads.

The port's copy of ``point_slam_tpu.tools.convert_lpips``. The reference
evaluates LPIPS through torchmetrics, which downloads AlexNet and the
calibration weights from the torch model zoo; run this tool once where the
``lpips`` package (or torchmetrics) and those weights are installed, and
point ``POINT_SLAM_LPIPS_NPZ`` at its output (or leave it at
weights/lpips_alex.npz):

    python -m point_slam_tpu_torch.tools.convert_lpips \\
        --out weights/lpips_alex.npz

Layout (all float32): ``shift``, ``scale`` (3,) input normalisation;
``conv{0..4}_w``, ``conv{0..4}_b`` AlexNet's feature convolutions;
``lin{0..4}_w`` the 1x1 calibration weights, clipped at 0. Without either
package the tool fails and says so.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping

import numpy as np

# AlexNet's convolutions sit at these indices of its feature slices
CONV_AT = (0, 3, 6, 8, 10)


def from_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The npz arrays from an LPIPS network's state dict (numpy)."""
    out = {"shift": sd["scaling_layer.shift"].reshape(3),
           "scale": sd["scaling_layer.scale"].reshape(3)}
    for i, idx in enumerate(CONV_AT):
        out[f"conv{i}_w"] = sd[f"net.slice{i + 1}.{idx}.weight"]
        out[f"conv{i}_b"] = sd[f"net.slice{i + 1}.{idx}.bias"]
    for i in range(len(CONV_AT)):
        out[f"lin{i}_w"] = np.maximum(
            sd[f"lin{i}.model.1.weight"].reshape(-1), 0.0)
    return out


def _numpy(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy()
            for k, v in module.state_dict().items()}


def from_lpips_package() -> Dict[str, np.ndarray]:
    import lpips as lpips_pkg        # richzhang/PerceptualSimilarity
    return from_state_dict(_numpy(lpips_pkg.LPIPS(net="alex",
                                                  spatial=False)))


def from_torchmetrics() -> Dict[str, np.ndarray]:
    from torchmetrics.image.lpip import LearnedPerceptualImagePatchSimilarity
    return from_state_dict(_numpy(
        LearnedPerceptualImagePatchSimilarity(net_type="alex").net))


def convert(out_path: str) -> str:
    """Write the npz to ``out_path`` from the lpips package, else from
    torchmetrics; returns which. Raises RuntimeError when neither
    imports."""
    try:
        out, src = from_lpips_package(), "lpips package"
    except ImportError as e_lpips:
        try:
            out, src = from_torchmetrics(), "torchmetrics"
        except ImportError as e_tm:
            raise RuntimeError(
                f"convert_lpips needs the lpips package or torchmetrics "
                f"(with AlexNet's weights) and this environment has neither "
                f"({e_lpips}; {e_tm}); run it where one is installed") \
                from e_tm
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **{k: v.astype(np.float32) for k, v in out.items()})
    print(f"wrote {out_path} from {src}: {sorted(out)} "
          f"({sum(v.size for v in out.values())} params)")
    return src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="weights/lpips_alex.npz")
    convert(ap.parse_args(argv).out)


if __name__ == "__main__":
    main()
