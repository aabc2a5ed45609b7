"""The AP gate (``tests/test_ap_convergence.py``'s recipes and floors) through
the port on the CPU: ``pointrcnn_tpu_torch.tools.ap_gate.run_gate`` trains
rpn then rcnn on the mini-KITTI fixture through the port's train CLI and
scores the written KITTI files with the official AP.  The port trains on
one device, so JAX's ``mesh_devices == 4`` assertion has no counterpart.
On the card: ``python -m pointrcnn_tpu_torch.tools.ap_gate [--striped]
[--people]``."""

import json

import pytest

from pointrcnn_tpu_torch.tools import ap_gate

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)


@pytest.mark.slow
def test_two_stage_pipeline_reaches_ap(tmp_path):
    ret = ap_gate.run_gate(str(tmp_path / "work"), rpn_epochs=250, rcnn_epochs=150,
                           num_samples=24, batch_size=4, device="cpu")
    print("ap_gate:", json.dumps({k: round(v, 2) for k, v in ret.items()}))
    assert ret["roi_recall_0.5"] >= 0.9, ret
    assert ret["recall_0.7"] >= 0.85, ret
    assert ret["final_total"] >= 40, ret
    assert ret["Car_3d_easy"] >= 65.0, ret
    assert ret["Car_bev_easy"] >= 78.0, ret
    assert ret["Car_image_easy"] >= 78.0, ret


@pytest.mark.slow
def test_multiclass_people_pipeline_reaches_ap(tmp_path):
    ret = ap_gate.run_gate(str(tmp_path / "work"), rpn_epochs=250, rcnn_epochs=150,
                           num_samples=24, batch_size=4, cfg_file=ap_gate.AP_CFG_PEOPLE,
                           classes=("Pedestrian", "Cyclist"), device="cpu")
    print("ap_gate(people):", json.dumps({k: round(v, 2) for k, v in ret.items()}))
    assert ret["recall_0.7"] >= 0.70, ret
    assert ret["final_total"] >= 32, ret
    assert ret["Pedestrian_3d_easy"] >= 40.0, ret
    assert ret["Cyclist_3d_easy"] >= 45.0, ret
    assert ret["Pedestrian_bev_easy"] >= 40.0, ret
    assert ret["Cyclist_bev_easy"] >= 45.0, ret
