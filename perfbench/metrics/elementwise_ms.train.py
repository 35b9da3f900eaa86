"""elementwise_ms.train: device milliseconds per traced training step of
torch's own kernels (``at::native`` names): AdamW's passes, the transposed
copies, the attention backward's oracle glue and the casts."""


def read(layer):
    trace = layer.get("trace")
    if trace is None or trace.busy_s <= 0 or not layer.get("steps"):
        return None
    return 1e3 * trace.kernel_seconds(lambda n: "at::native" in n) / layer["steps"]
