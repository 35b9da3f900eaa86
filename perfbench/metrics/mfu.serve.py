"""mfu.serve: model FLOPs of the traced run's window (2 x active parameters
per prefill and decode token) over the window times the bf16 peak
(989 TFLOP/s), in percent."""
from perfbench.core.roofline import PEAK_FLOPS_BF16


def read(layer):
    if not layer.get("window_s") or not layer.get("model_flops"):
        return None
    return 100.0 * layer["model_flops"] / (layer["window_s"] * PEAK_FLOPS_BF16)
