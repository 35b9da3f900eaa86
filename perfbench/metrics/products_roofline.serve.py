"""products_roofline.serve: the least time of the dense products the traced
steps ran (every decode tick over its slots; every prefill over its prompt,
the head at its last position alone: each weight read once, FLOPs from the
shapes; the larger of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s), over the
device time of the product kernels (``roofline.PRODUCT_KERNELS``), in
percent. Dense configurations only."""
from perfbench.core import roofline


def read(layer):
    trace, calls = layer.get("trace"), layer.get("calls")
    if trace is None or not calls or layer["config"].get("num_experts"):
        return None
    spent = trace.kernel_seconds(roofline.is_product)
    if spent <= 0:
        return None
    return 100.0 * roofline.forward_products_time(layer["config"], calls) / spent
