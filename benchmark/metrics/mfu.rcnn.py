"""The whole step's share of the card's bf16 peak, in %: the analytic
matmul operations of the rcnn-stage train step (``harness/flops.py``,
the config's Dense chains at 2 M K N, x3 for the trained RCNN's forward
and backward, x1 for the fixed RPN's forward)
times the steps of the window, over the window's wall time, over 989 TF/s
(the H100's dense bf16 peak at 700 W; the card's power limit is printed on
the run's earlier line)."""

from benchmark.harness import roofline


def install(d):
    pass


def read(d):
    return 100.0 * d.flops_per_step() * d.attempted / d.window_s / roofline.PEAK_BF16_PER_S
