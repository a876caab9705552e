"""The integration gate's ``--dp`` path on the CPU: ``run_gate(dp=2,
device="cpu")`` starts two gloo rank processes (``tools/train_end2end.py::
launch_ranks``, a rendezvous store the test process hosts), each training
one image of every 2-image batch with the data-parallel step.

After 2 steps rank 0's weights are within 1e-4 relative L2 by tensor of the
one-process gate whose step splits each 2-image batch into its images
(``run_gate(accum_steps=2)``: the DP step's arithmetic in one process),
and its ``per_eval`` within 1e-3 of the plain one-process gate's.  The
plain gate's weights differ from both by rounding alone: at the gate's
uncalibrated C4 weights (activations in the hundreds) a batch of 2 and two
batches of 1 round the convolutions' sums apart, and the BN-affine and
conv gradients, sums that cancel, carry that to ~3e-3 of their norm after
one step with no rank process involved; held at 1e-2."""

import numpy as np
import torch

from mx_rcnn_tpu_torch.tools import integration_gate as tgate

OUT_KEYS = {"mAP", "segm_AP50", "gate", "network", "steps", "per_eval"}
RANK_TIMEOUT_S = 240


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _worst(got, ref):
    assert got.keys() == ref.keys()
    return max((_rel_l2(got[k], ref[k]), k) for k in ref if ref[k].is_floating_point())


def test_two_rank_gate_matches_the_one_process_gate(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # each rank's torch threads
    torch.set_num_threads(2)
    kw = dict(network="resnet50", num_images=2, steps=2, eval_every=2, target=0, device="cpu")
    one = tgate.run_gate(**kw, params_out=str(tmp_path / "one.pt"))
    tgate.run_gate(**kw, params_out=str(tmp_path / "split.pt"), accum_steps=2)
    two = tgate.run_gate(**kw, dp=2, params_out=str(tmp_path / "two.pt"),
                         rank_timeout=RANK_TIMEOUT_S)
    assert OUT_KEYS <= set(two) and len(two["ranks"]) == 2
    assert two["steps"] == one["steps"] == 2
    # rank 1 trains and stops with rank 0 but does not evaluate
    assert two["ranks"][1]["steps"] == 2 and two["ranks"][1]["per_eval"] == []
    assert all(r["launches"]["nms"] == 0 for r in two["ranks"])  # plain versions on the CPU
    assert [s for s, _ in two["per_eval"]] == [s for s, _ in one["per_eval"]] == [2]
    np.testing.assert_allclose([m for _, m in two["per_eval"]],
                               [m for _, m in one["per_eval"]], atol=1e-3)
    got = torch.load(tmp_path / "two.pt")
    split_err = _worst(got, torch.load(tmp_path / "split.pt"))
    assert split_err[0] <= 1e-4, split_err
    plain_err = _worst(got, torch.load(tmp_path / "one.pt"))
    assert plain_err[0] <= 1e-2, plain_err
