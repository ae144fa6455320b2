"""The port's graft entry (gslam_tpu_torch.graft_entry) against the
repository's ``__graft_entry__.py``: the dry run over a gloo world of two
ranks on the CPU (psum and ring BA from a perturbed start, each cost
history below half its start; the rate by the iteration delta;
``sharded_track_batch`` of four frames; the fleet's merged map through
one distributed global BA with its keyframe ATE under 0.5 m), every rank
returning the same bits; ``entry()`` on the card only.
"""

import numpy as np
import pytest
import torch

from gslam_tpu_torch import graft_entry


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert out["world"] == 2 and out["backend"] == "gloo"
    assert out["placement"] == "gloo on the CPU"
    assert out["mesh"] == (2, 1)
    for name in ("costs", "ring_costs"):
        c = np.asarray(out[name])
        assert len(c) == 3 and c[-1] < 0.5 * c[0]
    assert out["dist_ba_iters_per_s"] > 0
    assert out["track_frames"] == 4 and out["inliers_min"] > 10
    assert out["kf_ate_m"] < 0.5 and min(out["fleet_keyframes"]) >= 1
    assert "dryrun_multichip OK (gloo on the CPU)" in capsys.readouterr().out


def test_mesh_shapes_follow_the_reference():
    assert [graft_entry.mesh_shape(n) for n in (1, 2, 4, 8)] == \
        [(1, 1), (2, 1), (2, 2), (4, 2)]
    p = graft_entry.ba_problem((2, 2), "cpu")
    assert tuple(p.obs_cam.shape) == (8, 4) and p.cam_pose.shape[0] == 4


def test_entry_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.entry()
