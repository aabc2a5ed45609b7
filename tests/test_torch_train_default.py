"""The port's ``rpn``-stage train step on the default config's kernel routes
(blockwise FPS, the banded and full-scan stride-class ball query, the
neighbourhood gather) against the JAX package's ``make_train_step``, cut to
tiny widths, three steps, with the tolerances of ``test_torch_train_step``
for bf16.

Both packages are put on the chip's routes as in
``test_torch_port_default``: JAX's Pallas ball-query and gather kernels in
interpret mode, the full-scan threshold lowered to 512 points; RPN SA1
(4096 points in 4 depth bands) takes the banded kernel, RPN SA2 (512
points) the full-scan kernel and the gather kernels forward and backward.
"""

from __future__ import annotations

from pointrcnn_tpu.config import load_config

from pointrcnn_tpu_torch.ops import cuda_ballquery

from test_torch_port_default import TINY_DEFAULT, kernel_routes  # noqa: F401 (fixture)
from test_torch_port_slice import _CFG, _count_routes, one_torch_thread  # noqa: F401 (fixture)
from test_torch_train_step import N_STEPS, TOL, Both, jax_routes  # noqa: F401 (fixture)


def test_default_train_steps_match_jax(monkeypatch, kernel_routes, jax_routes):
    cfg = load_config(str(_CFG), TINY_DEFAULT + ["RCNN.ENABLED", "False", "RPN.DP_RATIO", "0.0",
                                                 "COMPUTE_DTYPE", "bfloat16"])
    assert cfg.RPN.FPS_METHOD == "blockwise" and cfg.RPN.BALL_QUERY_METHOD == "approx"
    routes = _count_routes(monkeypatch, [(cuda_ballquery, "ball_query"),
                                         (cuda_ballquery, "ball_query_banded")])
    Both(cfg).run(TOL["bfloat16"])
    # per forward (one for the gradients, one in the step): SA1 banded, SA2
    # full scan and gathered (two scales), 3-NN in the three FP stages
    n_fwd = 2 * N_STEPS
    assert routes["ball_query_banded"] == n_fwd and routes["ball_query"] == n_fwd, routes
    assert routes["three_nn"] == 3 * n_fwd, routes
    assert jax_routes["jax"] >= 2 and jax_routes["port"] == 2 * n_fwd, jax_routes
