"""Device ms of the routed experts in the profiled calls, per heatmap: the
GEMM kernels of matrix products with an operand of the routed expert width
(``moe_intermediate_size``; the shared experts' width is a multiple of it,
so they are not counted), forward and backward, and the gathers, scatters
and sorts."""

LAYER = "MoE"
SOURCE = "device_trace"


def read(run):
    tr = run.trace
    hf = run.config["config"]
    if tr is None or not tr.heatmaps or "moe_intermediate_size" not in hf:
        return None
    experts, n = tr.expert_gemms(hf["moe_intermediate_size"])
    by = tr.by_class()
    us = experts + by.get("gathers, scatters and sorts", (0.0, 0))[0]
    return us / 1e3 / tr.heatmaps if n else None
