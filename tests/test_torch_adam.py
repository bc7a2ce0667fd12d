"""ops/adam.update's in-place step on the CPU: the functional formula
written into the given tensors (the mapper's path; on the card the
``multi_adam`` kernel, tests/test_torch_cuda.py), equal bit for bit to
``update(...)``, and the inputs it refuses."""

import numpy as np
import pytest
import torch

from point_slam_tpu_torch.ops import adam as tadam


def leaves(seed, n=300, w=72, live=200, f=10):
    """The mapper's shapes at a small size: an (n, w) leaf whose rows past
    ``live`` have zero gradient and moments, decoder-shaped tensors with
    element counts no multiple of 4, and an (f, 7) camera leaf. Returns
    (params, grads, m, v, t, lr), t and lr per tensor ((w,) rows for the
    leaf, numbers for the rest; the cameras' learning rate 0)."""
    rng = np.random.default_rng(seed)
    shapes = [(n, w), (128, 52), (128,), (3, 10), (3,), (3, 128), (f, 7)]

    def draw(shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    params = [draw(s) for s in shapes]
    grads = [draw(s) for s in shapes]
    m = [draw(s, 0.1) for s in shapes]
    v = [draw(s, 0.01).abs() for s in shapes]
    for x in (grads[0], m[0], v[0]):
        x[live:] = 0.0
    t = [torch.from_numpy(rng.integers(1, 40, w).astype(np.float32))]
    t += [7.0, 7.0, 3.0, 3.0, 12.0, 1.0]
    lr = [torch.from_numpy(rng.uniform(0, 3e-2, w).astype(np.float32))]
    lr += [1e-3, 1e-3, 5e-3, 5e-3, 1e-3, 0.0]
    return params, grads, m, v, t, lr


@pytest.mark.parametrize("rows", [None, "live", "none_live"])
def test_update_in_place_equals_the_functional_step(rows):
    """p, m and v written in place, returned as the same objects, equal
    to update(...) bit for bit; with ``rows`` the leaf's first rows only
    (200, or 0), the rows past them unchanged as update leaves them."""
    params, grads, m, v, t, lr = leaves(1)
    live = {None: None, "live": 200, "none_live": 0}[rows]
    if live == 0:
        grads[0].zero_()
        m[0].zero_()
        v[0].zero_()
    want_p, want = tadam.update(params, grads, {"m": m, "v": v}, t, lr)
    p_in, m_in, v_in = ([x.clone() for x in xs] for xs in (params, m, v))
    got_p, got = tadam.update(
        p_in, grads, {"m": m_in, "v": v_in}, t, lr, in_place=True,
        rows=None if rows is None else [live] + [None] * (len(params) - 1))
    for got_xs, given, want_xs in ((got_p, p_in, want_p),
                                   (got["m"], m_in, want["m"]),
                                   (got["v"], v_in, want["v"])):
        assert all(a is b for a, b in zip(got_xs, given))
        for a, b in zip(given, want_xs):
            assert torch.equal(a, b)
    assert torch.equal(p_in[0][200:], params[0][200:])
    assert torch.equal(p_in[-1], params[-1])          # learning rate 0


def _misshaped_row(args):
    args["t"][0] = args["t"][0][:71].clone()


def _wrong_dtype(args):
    args["grads"][2] = args["grads"][2].double()


def _mixed_devices(args):
    args["m"][1] = torch.empty(args["m"][1].shape, device="meta")


def _strided(args):
    args["params"][1] = args["params"][1].t()
    args["grads"][1] = args["grads"][1].t()
    args["m"][1] = args["m"][1].t().contiguous()
    args["v"][1] = args["v"][1].t().contiguous()


def _short_list(args):
    args["grads"] = args["grads"][:-1]


def _rows_past(args):
    args["rows"] = [301] + [None] * 6


@pytest.mark.parametrize("fault,match", [
    (_misshaped_row, "rows on"), (_wrong_dtype, "f32"),
    (_mixed_devices, "one device"), (_strided, "contiguous"),
    (_short_list, "length"), (_rows_past, "outside")])
def test_update_in_place_refuses_what_it_cannot_take(fault, match):
    """ValueError, before any tensor is written, on every device alike."""
    params, grads, m, v, t, lr = leaves(2)
    args = dict(params=params, grads=grads, m=m, v=v, t=t, lr=lr, rows=None)
    fault(args)
    before = [x.clone() for x in args["params"] if x.device.type == "cpu"]
    with pytest.raises(ValueError, match=match):
        tadam.update(args["params"], args["grads"],
                     {"m": args["m"], "v": args["v"]}, args["t"], args["lr"],
                     in_place=True, rows=args["rows"])
    after = [x for x in args["params"] if x.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_rows_are_stepped_in_place_only():
    params, grads, m, v, t, lr = leaves(3)
    with pytest.raises(ValueError, match="in place only"):
        tadam.update(params, grads, {"m": m, "v": v}, t, lr,
                     rows=[200] + [None] * 6)
