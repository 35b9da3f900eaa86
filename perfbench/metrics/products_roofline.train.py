"""products_roofline.train: the least time of the traced training steps'
dense products (forward, the remat recompute, dA and dB, each at its
shapes: the larger of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s) over
the device time of the product kernels (``roofline.PRODUCT_KERNELS``), in
percent. Dense configurations only."""
from perfbench.core import roofline


def read(layer):
    trace = layer.get("trace")
    if trace is None or layer["config"].get("num_experts"):
        return None
    spent = trace.kernel_seconds(roofline.is_product)
    if spent <= 0:
        return None
    least = roofline.train_products_time(layer["config"], layer["tokens"], layer["steps"],
                                         remat=layer["remat"])
    return 100.0 * least / spent
