"""Plain reference of Mistral: RMSNorm, GQA attention with RoPE and a causal
mask, a gated-SiLU MLP, the final norm and the head (``plain.py`` holds the
parts and the rules)."""

from bench_port.reference import plain


class Model(plain.Decoder):

    def layer(self, i, h, prec):
        h, x = self.attention_half(i, h, prec)
        pre = f"model.layers.{i}.mlp."
        return h + plain.gated_mlp(
            x, *(self.proj(pre + p + ".weight")
                 for p in ("gate_proj", "up_proj", "down_proj")), prec)
