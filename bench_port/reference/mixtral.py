"""Plain reference of Mixtral: Mistral's attention half, then a router over
E experts (softmax over all of them, the top K with the lower expert first
among equal probabilities, their weights renormalized with the sum held
constant), each chosen expert a gated-SiLU MLP, the outputs summed with
their weights under the uniform rule (``plain.py`` holds the parts and the
rules). The reference follows the routing of the heatmap it judges (see
``families/mixtral.py``'s ``Recorder``)."""

import math

import torch

from bench_port.reference import plain


class Model(plain.Decoder):
    """``follow(state)`` makes each layer take the experts of
    ``state["routes"]`` (``[T, K]`` ids per layer: the routing of the
    program, or of the control) in place
    of its own top K, with its own float32 probabilities as their weights.
    A token's gap is how far the router logit of the lower expert it takes
    lies below the reference's own K-th best (0 where the choices agree).
    ``numbers()`` then gives ``route_gap``, the widest gap over every token
    of the first layer, and ``route_gap_deep``, the mean gap over every
    token of the layers after it. The first layer is where both sides
    route the same input, the embedding, so a single token's wrong choice
    shows there; deeper, the float32 and bf16 residual streams part by
    more than a layer's rounding, and so do near-equal choices, whoever
    makes them: there the mean bounds the partings, and a router that reads
    the wrong input moves it far.
    ``record`` (a list), if set, receives the experts each layer takes in
    the first pass of :func:`plain.explain`."""

    routes = None
    record = None
    route_gap = 0.0
    _deep = (0.0, 0)

    def follow(self, state):
        """Take the judged run's ``state["routes"]``; with none (it
        recorded no routing) ``route_gap`` reads infinite."""
        self.routes = (state or {}).get("routes")
        self.route_gap = 0.0 if self.routes else math.inf
        self._deep = (0.0, 0)

    def numbers(self):
        if not math.isfinite(self.route_gap):
            return {"route_gap": math.inf, "route_gap_deep": math.inf}
        total, n = self._deep
        return {"route_gap": self.route_gap, "route_gap_deep": total / n if n else 0.0}

    def layer(self, i, h, prec):
        h, x = self.attention_half(i, h, prec)
        pre = f"model.layers.{i}.block_sparse_moe."
        E, K = self.hf["num_local_experts"], self.hf["num_experts_per_tok"]
        logits = plain.linear(x, self.proj(pre + "gate.weight"), prec)
        probs = torch.softmax(logits, -1)
        own = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
        top = own
        if self.routes is not None:
            if self.routes[i].shape != own.shape:    # not this prompt's routing
                self.route_gap = math.inf
            else:
                top = self.routes[i].to(own.device).long()
        if not torch.is_grad_enabled():       # the forward pass, once a layer
            if math.isfinite(self.route_gap):
                kth = logits.gather(-1, own[:, K - 1:])[:, 0]
                gap = (kth - logits.gather(-1, top).min(-1).values).clamp(min=0)
                if i == 0:
                    self.route_gap = float(gap.max())
                else:
                    total, n = self._deep
                    self._deep = (total + float(gap.sum()), n + gap.numel())
            if self.record is not None:
                self.record.append(top)
        w = probs.gather(-1, top)
        w = w / w.sum(-1, keepdim=True).detach()
        out = torch.zeros_like(h)
        for e in range(E):
            tok, slot = torch.nonzero(top == e, as_tuple=True)
            if not len(tok):
                continue
            y = plain.gated_mlp(
                x[tok], *(self.proj(pre + f"experts.{e}.{p}.weight")
                          for p in ("w1", "w3", "w2")), prec)
            out = out.index_add(0, tok, plain.grad_scale(w[tok, slot, None] * y, 0.5))
        return h + out
