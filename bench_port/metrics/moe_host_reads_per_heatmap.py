"""The mixture's host reads of its group sizes (``models.mixtral.routing``'s
``host_reads``, one per block run: forward and recompute) over the measured
window, per heatmap."""

LAYER = "MoE"
SOURCE = "program_counter"
COUNTERS = ["lxt_tpu_torch.models.mixtral:routing"]


def read(run):
    reads = run.counters["lxt_tpu_torch.models.mixtral:routing.host_reads"]
    return reads / run.heatmaps if reads and run.heatmaps else None
