"""Plain reference of DeepSeek-V3 (Moonlight-16B-A3B): latent attention,
then a dense gated-SiLU MLP in the first ``first_k_dense_replace`` layers
and, in the others, a sigmoid router over many small experts beside a
shared gated MLP (``plain.py`` holds the parts and the rules).

Latent attention as transformers writes it: ``q = x Wq`` (or through
``q_a_proj``, its RMSNorm and ``q_b_proj``) split per head into a no-rope
and a rope part; ``[c, k_pe] = x Wkv_a``, ``c`` through its RMSNorm (eps
1e-6, transformers' default for the latent norms), ``[k_nope, v] = c
Wkv_b`` per head; the rope parts in the checkpoint's interleaved layout
(``rope_interleave``, read as transformers' ``apply_rotary_pos_emb_interleave``
reads it) rotated with one key head shared by every query head; causal
attention at scale ``(qk_nope + qk_rope)^-0.5``. AttnLRP's gradient shares
are taken at the concatenated q, k (a quarter) and v (a half).

The router: float32 logits, ``s = sigmoid``, the top K of ``s + bias`` (the
groups outside the ``topk_group`` best set to 0 first where ``n_group >
1``, as transformers does), weighted by ``s`` alone, divided by their sum
held constant and multiplied by ``routed_scaling_factor``; each chosen
expert a gated-SiLU MLP, its output times its weight under the uniform
rule; the shared experts on every token, added.

``Model.cp = True`` takes CP-LRP's rules instead (the CPU tests hold the
port's ``cp_lrp`` to it): q and k carry no gradient and v all of it; the
gate of each gated product and each routing weight carry none.

Departures, each exact: ``plain.Attend`` takes one head dim for q, k and
v, so v is zero-padded to q's width and the output sliced back (the
padded columns give zero outputs, and their gradients are dropped). The
reference follows the routing of the heatmap it judges (see
``families/deepseek_v3.py``'s ``Recorder``).
"""

import math

import torch
import torch.nn.functional as F

from bench_port.reference import plain

LATENT_EPS = 1e-6


def gated_mlp(x, wg, wu, wd, prec, cp):
    """``plain.gated_mlp``, or under CP-LRP SiLU(x wg) held constant times
    x wu."""
    if not cp:
        return plain.gated_mlp(x, wg, wu, wd, prec)
    g = F.silu(plain.linear(x, wg, prec)).detach() * plain.linear(x, wu, prec)
    return plain.linear(g, wd, prec)


def deinterleave(x):
    """``[..., d]`` in the interleaved rope layout -> rotate-half layout."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def select(choice, hf, K):
    """The reference's own top K of the selection scores ``choice [T,
    E]``, group-limited where ``n_group > 1``; a stable descending sort."""
    G = hf.get("n_group") or 1
    if G > 1:
        E = choice.shape[-1]
        groups = choice.view(-1, G, E // G)
        score = groups.topk(2, dim=-1).values.sum(-1)
        best = torch.sort(score, dim=-1, descending=True, stable=True).indices[
            :, :hf.get("topk_group") or 1]
        keep = torch.zeros_like(score, dtype=torch.bool).scatter_(-1, best, True)
        choice = groups.masked_fill(~keep[..., None], 0.0).view(-1, E)
    return torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :K]


class Model(plain.Decoder):
    """``follow(state)`` makes each mixture layer take the experts of
    ``state["routes"]`` (``[T, K]`` ids per mixture layer) in place of its
    own top K, weighted by its own float32 scores. A token's gap is how
    far the selection score (``s + bias``) of the lowest expert it takes
    lies below the reference's own K-th best (0 where the choices agree).
    ``numbers()`` gives ``route_gap``, the widest gap over every token of
    the first mixture layer, and ``route_gap_deep``, the mean gap over
    every token of the mixture layers after it (as ``reference/mixtral.py``
    and for the same reasons). ``record`` (a list), if set, receives the
    experts each mixture layer takes in the first pass of
    :func:`plain.explain`."""

    routes = None
    record = None
    cp = False
    route_gap = 0.0
    _deep = (0.0, 0)

    def __init__(self, config, weight, device):
        super().__init__(config, weight, device)
        self.k_dense = self.hf.get("first_k_dense_replace", 0)

    def follow(self, state):
        self.routes = (state or {}).get("routes")
        self.route_gap = 0.0 if self.routes else math.inf
        self._deep = (0.0, 0)

    def numbers(self):
        if not math.isfinite(self.route_gap):
            return {"route_gap": math.inf, "route_gap_deep": math.inf}
        total, n = self._deep
        return {"route_gap": self.route_gap,
                "route_gap_deep": total / n if n else 0.0}

    def rope_cs(self, T):
        if self._rope[0] != T:
            self._rope = (T, plain.rope_tables(T, self.hf["qk_rope_head_dim"],
                                               self.hf["rope_theta"], self.device))
        return self._rope[1]

    def mla(self, i, x, prec):
        hf, pre = self.hf, f"model.layers.{i}.self_attn."
        T, H = x.shape[0], hf["num_attention_heads"]
        dn, dr, dv = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"], hf["v_head_dim"]
        r = hf["kv_lora_rank"]
        if hf.get("q_lora_rank") is None:
            q = plain.linear(x, self.proj(pre + "q_proj.weight"), prec)
        else:
            qa = plain.linear(x, self.proj(pre + "q_a_proj.weight"), prec)
            qa = plain.rms_norm(qa, self.w(pre + "q_a_layernorm.weight"), LATENT_EPS)
            q = plain.linear(qa, self.proj(pre + "q_b_proj.weight"), prec)
        q = q.view(T, H, dn + dr).transpose(0, 1)
        kv = plain.linear(x, self.proj(pre + "kv_a_proj_with_mqa.weight"), prec)
        c, k_pe = kv[:, :r], kv[:, r:]
        c = plain.rms_norm(c, self.w(pre + "kv_a_layernorm.weight"), LATENT_EPS)
        kvb = plain.linear(c, self.proj(pre + "kv_b_proj.weight"), prec)
        kvb = kvb.view(T, H, dn + dv).transpose(0, 1)
        k_nope, v = kvb[..., :dn], kvb[..., dn:]
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        k_pe = k_pe[None]
        if hf.get("rope_interleave", True):
            q_pe, k_pe = deinterleave(q_pe), deinterleave(k_pe)
        cos, sin = self.rope_cs(T)
        q_pe, k_pe = plain.rope(q_pe, cos, sin), plain.rope(k_pe, cos, sin)
        q = torch.cat([q_nope, q_pe], -1)
        k = torch.cat([k_nope, k_pe.expand(H, T, dr)], -1)
        shares = (0.0, 0.0, 1.0) if self.cp else (0.25, 0.25, 0.5)
        q, k, v = (plain.grad_scale(t, f) for t, f in zip((q, k, v), shares))
        a = plain.Attend.apply(q.contiguous(), k.contiguous(),
                               F.pad(v, (0, dn + dr - dv)).contiguous(),
                               (dn + dr) ** -0.5, prec)[..., :dv]
        return plain.linear(a.transpose(0, 1).reshape(T, H * dv),
                            self.proj(pre + "o_proj.weight"), prec)

    def layer(self, i, h, prec):
        pre = f"model.layers.{i}."
        eps = self.hf["rms_norm_eps"]
        x = plain.rms_norm(h, self.w(pre + "input_layernorm.weight"), eps)
        h = h + self.mla(i, x, prec)
        x = plain.rms_norm(h, self.w(pre + "post_attention_layernorm.weight"), eps)
        mlp = pre + "mlp."
        if i < self.k_dense:
            return h + gated_mlp(x, *(self.proj(mlp + p + ".weight") for p in
                                      ("gate_proj", "up_proj", "down_proj")), prec,
                                 self.cp)
        return h + self.moe(i, x, prec) + gated_mlp(
            x, *(self.proj(mlp + "shared_experts." + p + ".weight")
                 for p in ("gate_proj", "up_proj", "down_proj")), prec, self.cp)

    def moe(self, i, x, prec):
        hf, mlp = self.hf, f"model.layers.{i}.mlp."
        E, K = hf["n_routed_experts"], hf["num_experts_per_tok"]
        j = i - self.k_dense
        logits = plain.linear(x, self.w(mlp + "gate.weight"), prec)
        s = torch.sigmoid(logits)
        choice = s.detach() + self.w(mlp + "gate.e_score_correction_bias")
        own = select(choice, hf, K)
        top = own
        if self.routes is not None:
            if self.routes[j].shape != own.shape:    # not this prompt's routing
                self.route_gap = math.inf
            else:
                top = self.routes[j].to(own.device).long()
        if not torch.is_grad_enabled():       # the forward pass, once a layer
            if math.isfinite(self.route_gap):
                kth = choice.gather(-1, own[:, K - 1:])[:, 0]
                gap = (kth - choice.gather(-1, top).min(-1).values).clamp(min=0)
                if j == 0:
                    self.route_gap = float(gap.max())
                else:
                    total, n = self._deep
                    self._deep = (total + float(gap.sum()), n + gap.numel())
            if self.record is not None:
                self.record.append(top)
        w = s.gather(-1, top)
        if hf.get("norm_topk_prob", True):
            w = w / w.sum(-1, keepdim=True).detach()
        w = w * hf["routed_scaling_factor"]
        out = torch.zeros_like(x)
        for e in range(E):
            tok, slot = torch.nonzero(top == e, as_tuple=True)
            if not len(tok):
                continue
            y = gated_mlp(x[tok], *(self.proj(mlp + f"experts.{e}.{p}.weight")
                                    for p in ("gate_proj", "up_proj", "down_proj")),
                          prec, self.cp)
            we = w[tok, slot, None]
            out = out.index_add(0, tok, we.detach() * y if self.cp
                                else plain.grad_scale(we * y, 0.5))
        return out
