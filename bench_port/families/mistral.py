"""Mistral (the port's ``mistral`` family, run by ``models/llama.py``): a
dense gated-SiLU MLP after GQA attention with RoPE."""

from bench_port.harness import decoder

#: the port's family name
FAMILY = "mistral"


def tensors(config):
    """``name -> (shape, kind)`` of every tensor of the checkpoint."""
    hf = config["config"]
    D, I = hf["hidden_size"], hf["intermediate_size"]
    out = decoder.common_tensors(hf)
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}.mlp."
        out[pre + "gate_proj.weight"] = ((I, D), "weight")
        out[pre + "up_proj.weight"] = ((I, D), "weight")
        out[pre + "down_proj.weight"] = ((D, I), "weight")
    return out


def mlp_params_per_token(hf):
    """Parameters of the MLP's products that one token passes through."""
    return 3 * hf["hidden_size"] * hf["intermediate_size"]


def heatmap_flops(config, length):
    hf = config["config"]
    return decoder.heatmap_flops(hf, length, mlp_params_per_token(hf))


def attention_shape(config):
    return decoder.attention_shape(config["config"])


def build(config, state, device):
    return decoder.build(config, state, device, FAMILY)
