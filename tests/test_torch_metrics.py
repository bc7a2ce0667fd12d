"""Port parity, utils/metrics.py: PSNR, MS-SSIM (with the scale drop on
small images) and AlexNet-LPIPS (from a generated weights npz, as
tests/test_metrics.py makes one) against point_slam_tpu.utils.metrics on
the same seeded 64x80 images. Tolerances: rtol 1e-5 for PSNR and MS-SSIM
(the same f32 arithmetic, summed in another order), 1e-4 for LPIPS (five
convolution layers)."""

import numpy as np
import pytest
import torch

from point_slam_tpu.utils import metrics as JM
from point_slam_tpu_torch.utils import metrics as TM


def _images(seed, h=64, w=80, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(h, w)) > 0.2
    return a, b, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_psnr_matches_jax(masked):
    a, b, mask = _images(0)
    m = mask if masked else None
    want = JM.psnr(a, b, m)
    got = TM.psnr(torch.from_numpy(a), torch.from_numpy(b),
                  None if m is None else torch.from_numpy(m))
    assert got == pytest.approx(want, rel=1e-5)
    assert TM.psnr(a, b, m) == pytest.approx(want, rel=1e-5)   # numpy in


@pytest.mark.parametrize("shape", [(64, 80), (192, 200), (16, 40)],
                         ids=["64x80_3_levels", "192x200_5_levels",
                              "16x40_1_level"])
def test_ms_ssim_matches_jax(shape):
    a, b, _ = _images(1, *shape)
    for x, y in ((a, b), (a, a)):
        want = JM.ms_ssim(x, y)
        got = TM.ms_ssim(torch.from_numpy(x), torch.from_numpy(y))
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-5)


def test_ms_ssim_tiny_image_raises_like_jax():
    a = np.zeros((8, 160, 3), np.float32)
    with pytest.raises(ValueError):
        JM.ms_ssim(a, a)
    with pytest.raises(ValueError):
        TM.ms_ssim(a, a)


def _lpips_params(rng, ch=(16, 24, 32, 32, 32)):
    """Random weights with AlexNet-LPIPS topology, reduced channels (the
    generator of tests/test_metrics.py)."""
    p = {"shift": np.array([-0.030, -0.088, -0.188], np.float32),
         "scale": np.array([0.458, 0.448, 0.450], np.float32)}
    specs = [(ch[0], 3, 11), (ch[1], ch[0], 5), (ch[2], ch[1], 3),
             (ch[3], ch[2], 3), (ch[4], ch[3], 3)]
    for i, (o, c, k) in enumerate(specs):
        p[f"conv{i}_w"] = rng.normal(0, 0.15, (o, c, k, k)).astype(np.float32)
        p[f"conv{i}_b"] = rng.normal(0, 0.05, (o,)).astype(np.float32)
        p[f"lin{i}_w"] = rng.uniform(0, 0.1, (ch[i],)).astype(np.float32)
    return p


@pytest.fixture
def lpips_npz(tmp_path, monkeypatch):
    path = tmp_path / "lpips.npz"
    np.savez(path, **_lpips_params(np.random.default_rng(3)))
    monkeypatch.setenv(TM.LPIPS_NPZ_ENV, str(path))
    monkeypatch.setitem(JM._LPIPS_CACHE, "params", None)
    JM._LPIPS_CACHE.pop("params")
    yield path
    JM._LPIPS_CACHE.pop("params", None)


def test_lpips_matches_jax(lpips_npz):
    a, b, _ = _images(2)
    assert TM.lpips_available() and JM.lpips_available()
    want = JM.lpips(a, b)
    got = TM.lpips(torch.from_numpy(a), torch.from_numpy(b))
    assert want is not None and np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-4)
    params = TM.load_lpips_params("cpu")
    assert TM.lpips(a, b, params) == got
    assert TM.lpips(a, a, params) == pytest.approx(0.0, abs=1e-6)


def test_lpips_without_weights_is_none(tmp_path, monkeypatch):
    monkeypatch.setenv(TM.LPIPS_NPZ_ENV, str(tmp_path / "missing.npz"))
    a, b, _ = _images(4)
    assert not TM.lpips_available()
    assert TM.load_lpips_params() is None
    assert TM.lpips(a, b) is None
    # the JAX package's reason, naming the port's own converter
    assert TM.LPIPS_UNAVAILABLE.split(" — ")[0] == \
        JM.LPIPS_UNAVAILABLE.split(" — ")[0]
    assert "point_slam_tpu_torch.tools.convert_lpips" in TM.LPIPS_UNAVAILABLE
    assert TM.LPIPS_NPZ_ENV in TM.LPIPS_UNAVAILABLE
