"""The port's ``rpn``-stage train step against the JAX package's
``make_train_step``, three steps from the same weights and optimizer state
(``load_jax_variables`` + ``load_jax_opt_state``), on a tiny cut of
``cfgs/default.yaml`` with ``RCNN.ENABLED`` False and ``DP_RATIO`` 0.

Per step: the loss, the recorded ``grad_norm``, every gradient leaf (JAX's
from ``jax.grad`` of the same loss), then after the update every parameter
and every BN running statistic.  The SA2 table has 256 points, so in bf16
both packages take the neighbourhood-gather route (JAX's Pallas kernel in
interpret mode, the port's K4/K8 plain versions).

Tolerances, and why.  At the first step both packages hold the same
parameters, and every gradient leaf is held to its own norm,
``||g_port - g_jax|| <= rel * ||g_jax||``, so a leaf that is wrong by its
own size (zeroed, its sign flipped) fails however small it is.  In f32 the
worst leaves are 2.6e-2 apart, and where it was traced the departure is
JAX's: the last FP stage's output cotangent agrees to 1e-5, and against a
float64 recomputation of that stage's MLP from the same input and output
cotangent the port's layer-0 BN bias gradient is within 2e-7 of its norm,
JAX's XLA:CPU one 6.3e-3 (the port's FP gradients are held to float64 in
``test_fp_gradients_match_float64``), while a change of the input cloud by
one ulp moves JAX's leaves by 1.5e-5 only.  In bf16 the
gradients are sensitive to every bf16 rounding that a 1e-5 difference of
the forward can flip, JAX's as much as the port's: one ulp of the input
cloud moves JAX's own leaves by up to 0.18 of their norm.  After the first
update Adam has moved each parameter by about lr whatever its gradient's
size, so the packages hold slightly different parameters; later gradient
leaves are then held to a share of the global gradient norm, parameters
elementwise to ``2.5 * sum(lr)`` (measured: exactly 2 lr after the first
step) and in the mean to a small share of it, BN statistics relative to
each leaf's largest magnitude.  ``test_planted_faults_fail`` shows that
these bounds separate a wrong gradient: one BN bias cut from the graph, or
the gather backward overwriting rows where it must add, fails the first
step.  (The gather's ``dxyz`` and ``dcent`` reach no parameter; its VJP is
held exactly to JAX's in ``test_torch_train_gather``.)
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.ops import pallas_gather
from pointrcnn_tpu.train.loss import model_loss as jax_model_loss
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state
from pointrcnn_tpu.train.state import make_train_step as jax_make_train_step

from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_scene
from pointrcnn_tpu_torch.models import layers
from pointrcnn_tpu_torch.ops import cuda_gather
from pointrcnn_tpu_torch.train.loss import model_loss
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state, loss_and_grads, make_train_step

from test_torch_port_slice import (  # noqa: F401 (fixture)
    _CFG,
    TINY,
    _jax_three_nn_direct,
    one_torch_thread,
)

TRAIN_TINY = TINY + ["RCNN.ENABLED", "False", "RPN.DP_RATIO", "0.0"]
TOTAL_STEPS, STEPS_PER_EPOCH = 100, 10
N_STEPS = 3

# (loss rel, grad_norm rel, grad leaf at the first step relative to its own
# norm, grad leaf at later steps as a share of the global norm, mean |dp| as
# a share of 2 * sum(lr), BN statistics rel); measured worst (exact methods /
# default routes): f32 2e-7, 9e-4, 2.6e-2, 2.0e-2, 0.005, 3e-4;
# bf16 1.1e-5, 5.8e-3, 0.22 / 0.081, 7.2e-2, 0.037, 3.7e-3
TOL = {
    "float32": (1e-5, 5e-3, 0.05, 5e-2, 0.02, 2e-3),
    "bfloat16": (1e-4, 2e-2, 0.4, 0.15, 0.1, 2e-2),
}

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_names(tree) -> dict:
    """A flax tree -> {port name: numpy array}, Dense kernels transposed."""
    out = {}
    for path, leaf in _flat(jax.device_get(tree)):
        a = np.asarray(leaf)
        *mods, name = path
        if name == "kernel":
            name, a = "weight", a.T
        out[".".join([*mods, name])] = a
    return out


class Both:
    """JAX's and the port's train states on the same weights and batch."""

    def __init__(self, cfg, seed: int = 3):
        self.cfg = cfg
        scene = synthetic_scene(2, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=seed)
        self.jbatch = {k: jnp.asarray(v) for k, v in scene.items()}
        self.tbatch = {k: torch.from_numpy(v) for k, v in scene.items()}
        self.jm = JaxPointRCNN(cfg=cfg, mode="TRAIN")
        jtx = jax_build_optimizer(cfg, TOTAL_STEPS, STEPS_PER_EPOCH)
        self.js = jax_create_train_state(self.jm, cfg, self.jbatch, jtx, seed=0)
        self.jstep = jax_make_train_step(self.jm, cfg, jtx, donate=False)
        self.tx = build_optimizer(cfg, TOTAL_STEPS, STEPS_PER_EPOCH)
        self.ts = create_train_state(cfg, self.tx, device="cpu")
        load_jax_variables(self.ts.model, jax.device_get(
            {"params": self.js.params, "batch_stats": self.js.batch_stats}))
        load_jax_opt_state(self.ts.opt_state, jax.device_get(self.js.opt_state))
        self.tstep = make_train_step(cfg, self.tx)

        jm = self.jm

        def jax_grads(params, stats, batch):
            def loss_fn(p):
                out, _ = jm.apply({"params": p, "batch_stats": stats}, batch, train=True,
                                  bn_momentum=0.1, rngs={"dropout": jax.random.PRNGKey(0),
                                                         "target": jax.random.PRNGKey(1)},
                                  mutable=["batch_stats"])
                return jax_model_loss(cfg, out, batch)[0]
            return jax.grad(loss_fn)(params)

        self.jax_grads = jax.jit(jax_grads)

    def run(self, tol, n_steps=N_STEPS):
        loss_tol, gn_tol, leaf_rel, leaf_share, mean_tol, stat_tol = tol
        lr_sum = 0.0
        for step in range(n_steps):
            jg = _port_names(self.jax_grads(self.js.params, self.js.batch_stats, self.jbatch))
            # on a copy: the forward updates the BN running statistics
            _, _, tg = loss_and_grads(copy.deepcopy(self.ts.model), self.cfg, self.tbatch)
            g_norm = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2)) for a in jg.values()))
            assert set(tg) == set(jg)
            for k, a in jg.items():
                d = np.linalg.norm(tg[k].numpy().astype(np.float64) - a)
                bound = leaf_rel * np.linalg.norm(a) if step == 0 else leaf_share * g_norm
                assert d <= bound, f"step {step} grad {k}: {d} > {bound}"

            lr_sum += self.tx.lr(step)
            self.js, jtb = self.jstep(self.js, self.jbatch, jax.random.PRNGKey(0), 0.1)
            self.ts, ttb = self.tstep(self.ts, self.tbatch, 0.1)
            np.testing.assert_allclose(float(ttb["loss"]), float(jtb["loss"]), rtol=loss_tol)
            np.testing.assert_allclose(float(ttb["grad_norm"]), float(jtb["grad_norm"]),
                                       rtol=gn_tol)
            assert self.ts.step == int(self.js.step) == step + 1
            assert self.ts.opt_state["count"] == step + 1

            params = dict(self.ts.model.named_parameters())
            diffs = []
            for k, a in _port_names(self.js.params).items():
                d = np.abs(params[k].detach().numpy() - a)
                assert d.max() <= 2.5 * lr_sum, f"step {step} param {k}: {d.max()}"
                diffs.append(d.reshape(-1))
            assert np.concatenate(diffs).mean() <= mean_tol * 2 * lr_sum, step
            bufs = dict(self.ts.model.named_buffers())
            for k, a in _port_names(self.js.batch_stats).items():
                d = np.abs(bufs[k].numpy() - a).max()
                assert d <= stat_tol * np.abs(a).max(), f"step {step} stat {k}: {d}"


@pytest.fixture
def jax_routes(monkeypatch):
    """JAX's gather kernel in interpret mode, its off-TPU 3-NN on direct
    differences; both gather routes counted."""
    monkeypatch.setattr(pallas_gather, "_INTERPRET", True)
    _jax_three_nn_direct(monkeypatch)
    counts = {"jax": 0, "port": 0}
    orig_j = pallas_gather.group_points_pallas

    def jax_gather(*a):
        counts["jax"] += 1
        return orig_j(*a)

    monkeypatch.setattr(pallas_gather, "group_points_pallas", jax_gather)
    orig_t = cuda_gather.GroupPoints.apply

    def port_gather(*a):
        counts["port"] += 1
        return orig_t(*a)

    monkeypatch.setattr(cuda_gather.GroupPoints, "apply", port_gather)
    return counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_train_steps_match_jax(jax_routes, dtype):
    cfg = load_config(str(_CFG), EXACT_OVERRIDES + TRAIN_TINY + ["COMPUTE_DTYPE", dtype])
    both = Both(cfg)
    both.run(TOL[dtype])
    if dtype == "bfloat16":
        # SA2's two scales, traced once by JAX, run per gradient and step by the port
        assert jax_routes["jax"] >= 2 and jax_routes["port"] == 2 * 2 * N_STEPS, jax_routes
    else:
        assert jax_routes == {"jax": 0, "port": 0}


def _cut_from_graph(monkeypatch, mlp, name):
    """A planted fault: ``mlp`` reads its parameter ``name`` detached, so
    that parameter's gradient is zero."""
    mlp._planted = name  # copied with the model
    orig = torch.nn.Module.__getattr__

    def getattr_(self, attr):
        v = orig(self, attr)
        return v.detach() if attr == self.__dict__.get("_planted") else v

    monkeypatch.setattr(layers.SharedMLP, "__getattr__", getattr_)


def _overwrite_rows(monkeypatch):
    """A planted fault: the gather backward writes each cotangent row into
    the table where it must add it (the last write wins)."""

    def bwd(idx, ct, N):
        B, S, K, cout = ct.shape
        rows = (idx.long() + torch.arange(B)[:, None, None] * N).reshape(-1)
        dtable = torch.zeros((B * N, cout))
        dtable[rows] = ct.to(torch.bfloat16).float().reshape(-1, cout)
        return dtable.reshape(B, N, cout), -ct[..., 0:3].float().sum(2)

    monkeypatch.setattr(cuda_gather, "group_points_backward_plain", bwd)


@pytest.mark.parametrize("fault", ["bn_bias_cut", "gather_bwd_overwrites"])
def test_planted_faults_fail(jax_routes, monkeypatch, fault):
    dtype = "float32" if fault == "bn_bias_cut" else "bfloat16"
    cfg = load_config(str(_CFG), EXACT_OVERRIDES + TRAIN_TINY + ["COMPUTE_DTYPE", dtype])
    both = Both(cfg)
    if fault == "bn_bias_cut":
        # SA3's second scale, layer 1: its bias gradient is 2e-3 of the global norm
        net = both.ts.model.rpn.Pointnet2MSG_0
        _cut_from_graph(monkeypatch, net.SetAbstractionMSG_2.SharedMLP_1, "bn1_bias")
    else:
        _overwrite_rows(monkeypatch)
    with pytest.raises(AssertionError, match="step 0 grad"):
        both.run(TOL[dtype], n_steps=1)


@pytest.mark.parametrize("fp", [0, 1, 2])
def test_fp_gradients_match_float64(fp):
    """The port's f32 gradients of each FP stage's MLP against a float64
    recomputation of that MLP from the input and output cotangent it saw,
    relative to each leaf's norm (measured worst 3.9e-7)."""
    cfg = load_config(str(_CFG), EXACT_OVERRIDES + TRAIN_TINY + ["COMPUTE_DTYPE", "float32"])
    tx = build_optimizer(cfg, TOTAL_STEPS, STEPS_PER_EPOCH)
    model = create_train_state(cfg, tx, seed=1, device="cpu").model
    scene = synthetic_scene(2, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in scene.items()}
    mlp = getattr(model.rpn.Pointnet2MSG_0, f"FeaturePropagation_{fp}").SharedMLP_0
    seen = {}
    mlp.register_forward_pre_hook(lambda m, a: seen.update(x=a[0].detach()))
    mlp.register_forward_hook(lambda m, a, o: seen.update(out=o))
    model.train()
    params = dict(model.named_parameters())
    loss = model_loss(cfg, model(batch), batch)[0]
    *grads, out_ct = torch.autograd.grad(loss, [*params.values(), seen["out"]])
    grads = dict(zip(params, grads))

    ps = {k: v.detach().double().requires_grad_() for k, v in mlp.named_parameters()}
    h = seen["x"].double()
    for i in range(mlp.n):
        y = h @ ps[f"w{i}"]
        mean, var, _ = layers.batch_stats(y)
        h = torch.relu((y - mean) * torch.rsqrt(var + layers.BN_EPS) * ps[f"bn{i}_scale"]
                       + ps[f"bn{i}_bias"])
    f64 = torch.autograd.grad((h * out_ct.double()).sum(), list(ps.values()))
    prefix = f"rpn.Pointnet2MSG_0.FeaturePropagation_{fp}.SharedMLP_0."
    for k, want in zip(ps, f64):
        got = grads[prefix + k].double()
        assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(want), k
