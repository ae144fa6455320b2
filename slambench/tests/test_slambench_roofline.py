"""Bytes, operations and least times of B1 and B5 at the shapes of the
port's kernel table (PERF.md, "bound ms (by)"): B1 at 480x640 0.001100
ms (bytes), B5 at C = 8, P = 1024, O = 8 0.000238 ms (bytes)."""

import pytest
import torch

from slambench.roofline import fastnms, least_s, schur


def test_b1_at_vga():
    g = torch.Generator().manual_seed(0)
    img = torch.rand((480, 640), generator=g)
    n_bytes = 3 * 4 * 480 * 640
    t, by = least_s(n_bytes, fastnms.ops(img, 0.08))
    assert by == "bytes"
    assert round(t * 1e3, 6) == pytest.approx(0.001100)


def test_b1_arc_starts_of_a_bright_dot():
    img = torch.zeros((32, 32))
    img[15:18, 15:18] = 1.0              # a 3 x 3 dot
    assert fastnms.arc_starts(img, 0.08) > 0
    assert fastnms.arc_starts(torch.zeros((32, 32)), 0.08) == 0


def test_b5_at_c8_p1024_o8():
    C, P, O = 8, 1024, 8
    g = torch.Generator().manual_seed(0)
    obs_cam = torch.randint(0, C, (P, O), generator=g, dtype=torch.int32)
    obs_valid = torch.rand((P, O), generator=g) < 6 / 7
    n_bytes, n_ops = schur.launch_work(C, obs_cam, obs_valid)
    assert n_bytes == 797504
    t, by = least_s(n_bytes, n_ops)
    assert by == "bytes"
    assert round(t * 1e3, 6) == pytest.approx(0.000238)


def test_b5_counts_camera_pairs():
    obs_cam = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False]])
    _, n_ops = schur.launch_work(2, obs_cam, valid)
    assert n_ops == 2 * 395 + 40 + 4 * 216   # 2 cameras: 4 pairs
