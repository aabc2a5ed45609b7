"""Planted faults that the rcnn train-step comparison with JAX
(``test_torch_rcnn_step``) must catch: the K7 plain version dropping the
centroid gradient (``dcent``; RCNN SA1 folds, so it reaches the xyz rows of
its first weight) or the cotangent of one tied maximum.  Each must fail the
first step's gradient check of an RCNN leaf."""

from __future__ import annotations

import pytest

from test_torch_port_default import kernel_routes  # noqa: F401 (fixture)
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_mlp_bwd import _drop_dcent, _drop_one_tie
from test_torch_rcnn_step import TOL, RcnnBoth, _kernel_cfg, jax_fused  # noqa: F401 (fixture)
from test_torch_train_step import jax_routes  # noqa: F401 (fixture)


@pytest.mark.parametrize("fault", ["dcent_dropped", "tie_dropped"])
def test_planted_faults_fail(kernel_routes, jax_routes, jax_fused, monkeypatch, fault):
    both = RcnnBoth(_kernel_cfg())
    both.share_rpn_outputs(monkeypatch)
    (_drop_dcent if fault == "dcent_dropped" else _drop_one_tie)(monkeypatch)
    with pytest.raises(AssertionError, match="step 0 grad rcnn_net"):
        both.run(TOL["kernel_routes"], n_steps=1)
