"""The rcnn train step against JAX's in the exact methods and f32
(``test_torch_rcnn_step``'s first setting): every SA stack of both packages
on the generic route, the target layer, the loss and the optimizer held to
JAX's for three steps."""

from __future__ import annotations

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_step import TOL, RcnnBoth, _count_fused, _exact_cfg
from test_torch_train_step import jax_routes  # noqa: F401 (fixture)


def test_exact_rcnn_steps_match_jax(jax_routes, monkeypatch):
    counts = _count_fused(monkeypatch)
    RcnnBoth(_exact_cfg()).run(TOL["exact"])
    # f32: every SA stack of both packages on the generic route
    assert counts == {"fwd": 0, "bwd": 0}, counts
