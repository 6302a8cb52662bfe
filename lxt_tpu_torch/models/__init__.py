"""Model zoo: LRP-aware transformers + HF weight conversion. Import the
family module you need (``from lxt_tpu_torch.models import llama``)."""
