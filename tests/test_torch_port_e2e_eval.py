"""The port's learned evaluator proofs on the CPU: ``e2e_fused_train``'s
recipe (its refusal of a ragged batch, and a checkpoint where the fused
evaluators look), and ``e2e_lmo``, ``e2e_ycb`` and ``e2e_overflow_retry``
at ``--small --device cpu``, in-process, each under the JAX script's small
criterion and with the JAX record's keys (``test_torch_port_e2e.run_main``).
The comparisons against the JAX scripts are in ``test_torch_port_e2e.py``.
"""

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch.scripts import (e2e_fused_train, e2e_lmo,
                                       e2e_overflow_retry, e2e_synthetic,
                                       e2e_ycb)
from tests.test_torch_port_e2e import (  # noqa: F401
    _port_world, one_thread, run_main)
from tests.torch_port_threads import port_threads  # noqa: F401


@pytest.mark.usefixtures("one_thread")
def test_fused_recipe_refuses_a_ragged_batch_and_saves_where_eval_looks(
        tmp_path):
    from rcvpose_tpu_torch.config import Config

    k, poses, images, depths, _, max_radii, _ = _port_world()
    cfg = Config(compute_dtype="float32", image_height=64, image_width=64,
                 batch_size=4, max_iterations=1, kpt_heads=3,
                 model_blocks="1,1,1,1", model_width=0.125)
    with pytest.raises(ValueError, match="multiple of the batch size 4"):
        e2e_fused_train.train_fused_checkpoint(
            cfg, images, depths, poses, e2e_synthetic.KEYPOINTS_M, max_radii,
            k, 6, str(tmp_path / "x"), "cpu")
    it, val = e2e_fused_train.train_fused_checkpoint(
        cfg, images, depths, poses, e2e_synthetic.KEYPOINTS_M, max_radii, k,
        8, str(tmp_path / "m" / "ape"), "cpu")
    assert it == 1 and np.isfinite(val)
    ecfg = Config(model_dir=str(tmp_path / "m"), kpt_heads=3,
                  compute_dtype="float32", model_blocks="1,1,1,1",
                  model_width=0.125)
    (net,) = port_eval._load_models(ecfg, "ape", torch.device("cpu"))
    seg, radial = net(torch.zeros(1, 64, 64, 3))
    assert seg.shape == radial.shape == (1, 64, 64, 3)


@pytest.mark.usefixtures("one_thread")
def test_lmo_proof_runs_on_the_cpu(tmp_path, capsys):
    rc, rec = run_main(e2e_lmo, ["--small", "--device", "cpu", "--out",
                                 str(tmp_path)], capsys)
    assert rc == 0
    # the poseless frame was written and skipped: exactly n_test scored
    assert rec["frames"] == 2 and rec["frames_written"] == 3
    assert (tmp_path / "ckpts" / "ape" / "ckpt.pth.tar").is_file()


@pytest.mark.usefixtures("one_thread")
def test_ycb_proof_runs_on_the_cpu(tmp_path, capsys):
    rc, rec = run_main(e2e_ycb, ["--small", "--icp_compare", "--test_frames",
                                 "1", "--device", "cpu", "--out",
                                 str(tmp_path)], capsys)
    assert rc == 0
    assert rec["frames"] == 1
    cmp_ = rec["icp_criteria_compare"]
    assert set(cmp_) == {"converged_auc_af", "fixed30_auc_af", "auc_delta"}


def test_overflow_retry_runs_on_the_cpu(capsys):
    rc, rec = run_main(e2e_overflow_retry, ["--small", "--device", "cpu"],
                       capsys)
    assert rc == 0
    assert rec["frames"] == 2 and rec["overflow_frames"] == 1
    assert rec["eval_add_after_icp"] == 1.0
    for key in ("value", "clean_frame_ms_per_kpt",
                "retry_grid256_first_call_ms", "base_grid192_first_call_ms"):
        assert rec[key] > 0
