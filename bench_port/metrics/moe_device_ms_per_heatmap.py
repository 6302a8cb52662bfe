"""Device ms of the mixture in the profiled calls, per heatmap: the GEMM
kernels of matrix products with an operand of the expert width (the
experts' products, forward and backward), K3 ``nf4_dequant``, and the
gathers, scatters and sorts."""

LAYER = "MoE"
SOURCE = "device_trace"


def read(run):
    tr = run.trace
    hf = run.config["config"]
    if tr is None or not tr.heatmaps or "num_local_experts" not in hf:
        return None
    experts, n = tr.expert_gemms(hf["intermediate_size"])
    by = tr.by_class()
    us = experts + sum(by[c][0] for c in ("K3 nf4_dequant",
                                          "gathers, scatters and sorts")
                       if c in by)
    return us / 1e3 / tr.heatmaps if n else None
