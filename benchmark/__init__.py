"""The benchmark of pointrcnn_tpu_torch: ``python benchmark/run.py --help``."""
