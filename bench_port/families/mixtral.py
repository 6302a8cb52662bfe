"""Mixtral (the port's ``mixtral`` family, ``models/mixtral.py``): GQA
attention with RoPE, then a router over E experts of which each token takes
its top K."""

from bench_port.harness import decoder

#: the port's family name
FAMILY = "mixtral"


def tensors(config):
    """``name -> (shape, kind)`` of every tensor of the checkpoint."""
    hf = config["config"]
    D, I, E = hf["hidden_size"], hf["intermediate_size"], hf["num_local_experts"]
    out = decoder.common_tensors(hf)
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}.block_sparse_moe."
        out[pre + "gate.weight"] = ((E, D), "weight")
        for e in range(E):
            out[pre + f"experts.{e}.w1.weight"] = ((I, D), "weight")
            out[pre + f"experts.{e}.w2.weight"] = ((D, I), "weight")
            out[pre + f"experts.{e}.w3.weight"] = ((I, D), "weight")
    return out


def mlp_params_per_token(hf):
    """Parameters of the products that one token passes through in the
    mixture: the router and its top K experts."""
    D, I = hf["hidden_size"], hf["intermediate_size"]
    return D * hf["num_local_experts"] + hf["num_experts_per_tok"] * 3 * D * I


def heatmap_flops(config, length):
    hf = config["config"]
    return decoder.heatmap_flops(hf, length, mlp_params_per_token(hf))


def attention_shape(config):
    return decoder.attention_shape(config["config"])


def build(config, state, device):
    return decoder.build(config, state, device, FAMILY)


class Recorder:
    """The program's routing, as the reference follows it.

    With it entered, the first ``num_hidden_layers`` calls of
    ``models.mixtral._route`` in a call (the router's top K of the forward,
    one a layer; remat's recompute is not kept) append their expert ids
    ``[N, K]`` to a list, on the device and with no synchronisation.
    :meth:`take` gives each kept prompt of the last call its ids at its own
    positions, one ``[length, K]`` tensor per layer, copied out in one
    stack (the pipeline left-pads every prompt to the call's common length,
    so prompt j holds the last ``length`` rows of row block j), and lets go
    of the rest: what a run holds of the routing does not grow with its
    calls. Where the reference followed its own routing instead, the top K
    would part from the program's wherever two experts' router
    probabilities lie within rounding of each other, and each such parting
    changes that token's layer output wholesale: the judged maps would then
    measure those partings and not the program's precision. The partings
    themselves are judged apart, as ``route_gap`` and ``route_gap_deep``
    (``reference/mixtral.py``)."""

    def __init__(self, config):
        self.layers = config["config"]["num_hidden_layers"]
        self.routes = []

    def __enter__(self):
        from lxt_tpu_torch.models import mixtral
        self._module, self._route = mixtral, mixtral._route

        def route(*args, **kw):
            top_w, top_idx = self._route(*args, **kw)
            if len(self.routes) < self.layers:
                self.routes.append(top_idx)
            return top_w, top_idx

        mixtral._route = route
        return self

    def __exit__(self, *exc):
        self._module._route = self._route

    def take(self, prompts, keep):
        """The last call's routing of its prompts ``keep`` (indices),
        ``{j: {"routes": [...]}}`` (``None`` for each where the call routed
        nothing that fits), and a fresh list for the next call."""
        import torch
        forward, self.routes = self.routes, []
        if not keep:
            return {}
        if len(forward) < self.layers or forward[0].shape[0] % len(prompts):
            return dict.fromkeys(keep)
        T = forward[0].shape[0] // len(prompts)
        return {j: {"routes": list(torch.stack(
            [idx.view(len(prompts), T, -1)[j, T - len(prompts[j]):]
             for idx in forward]).unbind(0))} for j in keep}
