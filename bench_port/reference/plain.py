"""The plain reference's shared parts: plain PyTorch in float32 (TF32 off),
no kernel, no cache, no batching, one prompt at a time.

A heatmap is Gradient x Input under AttnLRP's rules, each written as the
gradient of a slightly changed function:

- RMSNorm: the identity rule, the reciprocal root held constant;
- a linear layer: the epsilon rule, which is its plain gradient;
- attention: q and k take a quarter of their gradient, v a half (the
  uniform rule over the two bilinear products), softmax its plain gradient;
- SiLU: the identity rule, the gradient times SiLU(x) / x;
- a product of two activations (gate times up, routing weight times
  expert output): the uniform rule, each factor half the gradient.

``prec="fp8"`` is the control: every matrix product, forward and backward,
takes its operands rounded to float8 e4m3 with one scale per row of the
left operand and per column of the right one, as an fp8 GEMM would.

:func:`explain` runs a model layer by layer so that it fits beside the
program: the forward keeps each layer's input, and the backward computes
each layer again from it.
"""

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
#: the NF4 codebook (QLoRA): the 16 quantiles of a standard normal scaled
#: to [-1, 1]
NF4 = (-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
       -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
       0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
       0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
       0.7229568362236023, 1.0)
#: rows of a chunk of attention scores times keys, at most
CHUNK = 1 << 27


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t, dim):
    """``t`` rounded to float8 e4m3, scaled so that each slice along ``dim``
    has its largest magnitude at 448."""
    scale = FP8_MAX / t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def mm(a, b, prec):
    """``a @ b`` (contracting a's last axis with b's second to last)."""
    if prec == "fp8":
        a, b = fp8(a, -1), fp8(b, -2)
    return a @ b


class Linear(torch.autograd.Function):
    """``x @ w.T`` for ``w [out, in]``; the input's gradient only."""

    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(w)
        ctx.prec = prec
        return mm(x, w.T, prec)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return mm(g, w, ctx.prec), None, None


def linear(x, w, prec):
    return Linear.apply(x, w, prec)


class GradScale(torch.autograd.Function):
    """Identity forward; the backward multiplies the gradient by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def grad_scale(x, factor):
    return GradScale.apply(x, factor)


class SiluIdentity(torch.autograd.Function):
    """SiLU under the identity rule: the gradient times SiLU(x) / x."""

    @staticmethod
    def forward(ctx, x):
        out = F.silu(x)
        ctx.save_for_backward(out / (x + 1e-10))
        return out

    @staticmethod
    def backward(ctx, g):
        (ratio,) = ctx.saved_tensors
        return g * ratio


def silu(x):
    return SiluIdentity.apply(x)


def rms_norm(x, w, eps):
    """RMSNorm with its reciprocal root held constant (identity rule)."""
    rs = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps).detach()
    return x * rs * w


def rope_tables(T, head_dim, theta, device):
    """cos and sin ``[T, head_dim]`` of positions 0..T-1 (half frequencies
    repeated, the HF layout), the angles in float64."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64)
                          / head_dim)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)
    return (torch.cos(ang).float().to(device), torch.sin(ang).float().to(device))


def rope(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def _blocks(T, rows_per_q):
    """Query blocks ``(start, end)`` whose scores against their causal keys
    fit in :data:`CHUNK` elements."""
    step = max(1, min(T, CHUNK // max(1, rows_per_q * T)))
    return [(a, min(T, a + step)) for a in range(0, T, step)]


def _probs(q, k, a, b, scale, prec):
    """Causal softmax of the scores of queries a..b-1 against keys 0..b-1."""
    s = mm(q[:, a:b], k[:b].T, prec) * scale
    qi = torch.arange(a, b, device=q.device)[:, None]
    kj = torch.arange(b, device=q.device)[None]
    return torch.softmax(s.masked_fill(kj > qi, float("-inf")), -1)


class Attend(torch.autograd.Function):
    """Causal softmax attention, q ``[H, T, D]``, k and v ``[Hkv, T, D]``
    (GQA: query head h reads key head h // (H / Hkv)), computed in chunks
    of query rows; the backward computes each chunk's probabilities again."""

    @staticmethod
    def forward(ctx, q, k, v, scale, prec):
        H, T, _ = q.shape
        r = H // k.shape[0]
        out = torch.empty_like(q)
        for j in range(k.shape[0]):
            qg = q[j * r:(j + 1) * r]
            for a, b in _blocks(T, r):
                p = _probs(qg, k[j], a, b, scale, prec)
                out[j * r:(j + 1) * r, a:b] = mm(p, v[j, :b], prec)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale, ctx.prec = scale, prec
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        scale, prec = ctx.scale, ctx.prec
        H, T, _ = q.shape
        r = H // k.shape[0]
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        delta = (do * out).sum(-1, keepdim=True)
        for j in range(k.shape[0]):
            hs = slice(j * r, (j + 1) * r)
            qg = q[hs]
            for a, b in _blocks(T, r):
                p = _probs(qg, k[j], a, b, scale, prec)
                dog = do[hs, a:b]
                dv[j, :b] += mm(p.transpose(-1, -2), dog, prec).sum(0)
                dp = mm(dog, v[j, :b].T, prec)
                ds = p * (dp - delta[hs, a:b]) * scale
                dq[hs, a:b] = mm(ds, k[j, :b], prec)
                dk[j, :b] += mm(ds.transpose(-1, -2), qg[:, a:b], prec).sum(0)
        return dq, dk, dv, None, None


def attention(x, wq, wk, wv, wo, hf, rope_cs, prec):
    """The attention half of a layer on a normed ``x [T, D]``: projections,
    RoPE, AttnLRP's gradient shares at q, k and v, causal GQA attention,
    the output projection."""
    T = x.shape[0]
    H = hf["num_attention_heads"]
    Hkv = hf.get("num_key_value_heads") or H
    hd = hf.get("head_dim") or hf["hidden_size"] // H
    q = linear(x, wq, prec).view(T, H, hd).transpose(0, 1)
    k = linear(x, wk, prec).view(T, Hkv, hd).transpose(0, 1)
    v = linear(x, wv, prec).view(T, Hkv, hd).transpose(0, 1)
    q, k, v = grad_scale(q, 0.25), grad_scale(k, 0.25), grad_scale(v, 0.5)
    cos, sin = rope_cs
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    a = Attend.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                     hd ** -0.5, prec)
    return linear(a.transpose(0, 1).reshape(T, H * hd), wo, prec)


def gated_mlp(x, wg, wu, wd, prec):
    """SiLU(x wg) * (x wu), then wd, under the identity and uniform rules."""
    g = grad_scale(silu(linear(x, wg, prec)) * linear(x, wu, prec), 0.5)
    return linear(g, wd, prec)


def nf4(w, block):
    """``w [out, in]`` through NF4 and back, in float32: one absmax per
    ``block`` inputs of each output, each weight to the nearest code (a
    weight on a midpoint takes the lower code)."""
    code = torch.tensor(NF4, dtype=torch.float32, device=w.device)
    mid = (code[1:] + code[:-1]) / 2
    out, inn = w.shape
    blocks = w.float().reshape(out, inn // block, block)
    absmax = blocks.abs().amax(-1, keepdim=True)
    idx = torch.searchsorted(mid, (blocks / absmax.clamp(min=1e-12)).contiguous())
    return (code[idx] * absmax).reshape(out, inn)


def nf4_block(inn, block):
    """The block size along an input axis of ``inn``: the largest power of
    two not above ``block`` that divides it."""
    while block > 2 and inn % block:
        block //= 2
    return block


def explain(model, ids, token=None, prec="f32"):
    """The reference's heatmap of one prompt ``ids [T]`` (on the model's
    device) explaining ``token``'s logit at the next position (None: its
    own argmax). Returns ``{"best": its best logit, "token", "logit": the
    token's, "relevance": [T] numpy}``."""
    with torch.no_grad():
        hs = [model.embed(ids)]
        for i in range(model.num_layers):
            hs.append(model.layer(i, hs[-1], prec))
    with torch.enable_grad():
        last = hs[-1][-1].clone().requires_grad_()
        z = model.head(last, prec)
        best = int(z.detach().argmax())
        token = best if token is None else int(token)
        (g,) = torch.autograd.grad(z[token], last)
    grad = torch.zeros_like(hs[-1])
    grad[-1] = g
    for i in reversed(range(model.num_layers)):
        hs.pop()
        with torch.enable_grad():
            h_in = hs[i].detach().requires_grad_()
            (grad,) = torch.autograd.grad(model.layer(i, h_in, prec), h_in, grad)
    z = z.detach()
    return {"best": float(z[best]), "token": token, "logit": float(z[token]),
            "relevance": (hs[0] * grad).sum(-1).cpu().numpy()}


class Decoder:
    """What both families' references share: the embedding, the head and
    the weights, each drawn by name (``weight(name)`` gives the tensor in
    the checkpoint's type on the device), NF4 projections worked out again
    from those draws where the configuration quantizes them."""

    def __init__(self, config, weight, device):
        self.config, self.hf = config, config["config"]
        self.weight, self.device = weight, device
        self.num_layers = self.hf["num_hidden_layers"]
        self.quant = config.get("quantization")
        self._rope = (None, None)

    def follow(self, state):
        """Follow what the judged run recorded of its state beyond the
        explained token (nothing, for a dense model)."""

    def numbers(self):
        """Numbers of the last :func:`explain` besides the heatmap's."""
        return {}

    def w(self, name):
        return self.weight(name).float()

    def proj(self, name):
        """A layer's projection ``[out, in]`` in float32, through NF4 and
        back where the configuration quantizes the layers' projections."""
        w = self.weight(name)
        if self.quant is None:
            return w.float()
        return nf4(w, nf4_block(w.shape[1], self.quant["block"]))

    def rope_cs(self, T):
        if self._rope[0] != T:
            hd = self.hf.get("head_dim") or (self.hf["hidden_size"]
                                             // self.hf["num_attention_heads"])
            self._rope = (T, rope_tables(T, hd, self.hf["rope_theta"],
                                         self.device))
        return self._rope[1]

    def embed(self, ids):
        return self.weight("model.embed_tokens.weight")[ids].float()

    def head(self, h, prec):
        x = rms_norm(h, self.w("model.norm.weight"), self.hf["rms_norm_eps"])
        name = ("model.embed_tokens.weight" if self.hf.get("tie_word_embeddings")
                else "lm_head.weight")
        return linear(x[None], self.w(name), prec)[0]

    def attention_half(self, i, h, prec):
        """``h`` plus the attention half of layer ``i``, and its normed
        output for the MLP."""
        pre = f"model.layers.{i}."
        eps = self.hf["rms_norm_eps"]
        x = rms_norm(h, self.w(pre + "input_layernorm.weight"), eps)
        h = h + attention(
            x, *(self.proj(pre + f"self_attn.{p}.weight")
                 for p in ("q_proj", "k_proj", "v_proj", "o_proj")),
            self.hf, self.rope_cs(h.shape[0]), prec)
        return h, rms_norm(h, self.w(pre + "post_attention_layernorm.weight"), eps)

