"""mfu.train: model FLOPs of the traced run's window (6 x active parameters
per token of every step that ended in it) over the window times the bf16 peak
(989 TFLOP/s), in percent."""
from perfbench.core.roofline import PEAK_FLOPS_BF16


def read(layer):
    if not layer.get("window_s") or not layer.get("model_flops"):
        return None
    return 100.0 * layer["model_flops"] / (layer["window_s"] * PEAK_FLOPS_BF16)
