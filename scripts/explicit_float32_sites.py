#!/usr/bin/env python3
"""Where the explicit path's float32 maps part from float64, on one NVIDIA
GPU: chip_smoke.py's phase 18 (b) configuration (each family at full width
cut to 2 layers, float32, one row, random weights from its seed), run on
the card in float32 and float64 and on the host CPU in float32, with the
graph of each kept.

For each rule site (a custom Function of the backward, in backward order
of its walk), the relevance it receives and the relevance it returns,
each against the float64 run's (normalized L2): a site whose output
distance is far above its input distance amplifies rounding. At the
epsilon-rule sites (``linear_epsilon``, ``matmul``, ``add2``,
``layer_norm``) also the element of the denominator (output + epsilon,
``lxt_tpu``'s plain ``+``) whose float32 rounding moves the relevance it
divides most.
Then the counterfactual: the card's float32 backward run again over the
same graph with that one element of the most amplifying site's saved
output set to the float64 value; if the map's distance from float64 falls
to the CPU's, that one denominator is what set it.

    python3 scripts/explicit_float32_sites.py [--families bert,llama,gpt2]
        [--table PATH]

Prints the card's nvidia-smi name and power limit first, then for each
family the maps' distances, the three most amplifying sites and the
counterfactual; ``--table`` writes every site's line to PATH.
"""

import os
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

#: the epsilon-rule Functions and the denominator each divides by, from its
#: saved tensors and its epsilon
DENOMINATORS = {
    "_LinearEpsilon": lambda saved, eps: saved[2] + eps,
    "_Matmul": lambda saved, eps: 2 * saved[2] + eps,
    "_Add2": lambda saved, eps: saved[0] + saved[1] + eps,
    "_LayerNorm": lambda saved, eps: saved[3] + eps,
}
#: the Functions whose saved output (index 2) is the denominator's
EDITABLE = ("_LinearEpsilon", "_Matmul")


def rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    norm = want.norm().item()
    return (got - want).norm().item() / norm if norm else float((got != want).any())


def worst_denominator(name, nodes, received):
    """The denominator element whose float32 rounding on the card moves the
    relevance ``received / denominator`` most: ``(its relative error, flat
    index, float64 value, card value, CPU value)``."""
    import torch
    eps = nodes[0].epsilon
    d = [DENOMINATORS[name](n.saved_tensors, eps).double().cpu().flatten() for n in nodes]
    moved = received.double().cpu().flatten().abs() * (1 / d[0] - 1 / d[1]).abs()
    i = int(torch.where(torch.isnan(moved), 0.0, moved).argmax())   # masked: inf - inf
    return (abs(d[0][i] - d[1][i]) / abs(d[1][i])).item(), i, d[1][i].item(), \
        d[0][i].item(), d[2][i].item()


def where(node, nodes):
    """The forward line that made ``node`` and, counting from 0, which of
    that line's sites it is in forward order (in a layer loop whose line
    runs once a layer, the layer)."""
    from lxt_tpu_torch.rule_audit import _site
    site = _site(node)
    same = sorted((n for n in nodes if _site(n) == site), key=lambda n: n._sequence_nr())
    return f"{site} #{same.index(node)}"


def family_sites(family, log):
    import torch
    cfg, params, ids, comp, _, ex, embed = cs.explicit_setup(family, cs.EXPLICIT_GATE_LAYERS)
    kw = {}
    if family == "bert":
        kw = {"attention_mask": (torch.arange(cs.SEQ_BERT, device="cuda")[None]
                                 < cs.BERT_REAL).int()}
    cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
           for k, v in params.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # anomaly mode's notice
        # anomaly mode keeps each node's forward traceback: where() reads it
        with torch.autograd.detect_anomaly(check_nan=False):
            card32, sites32, again = cs.explicit_sites(family, cfg, params, comp, ex, embed,
                                                       ids, **kw)
    nodes32 = [n for n, _, _ in sites32]
    # each run's third value keeps its graph, and the saved tensors, alive
    card64, sites64, graph64 = cs.explicit_sites(family, cfg, cs.cast(params, torch.float64),
                                                 comp, ex, embed, ids, **kw)
    cpu32, sitescpu, graphcpu = cs.explicit_sites(family, cfg, cpu, comp, ex, embed, ids.cpu(),
                                                  **{k: v.cpu() for k, v in kw.items()})
    names = [n._forward_cls.__name__ for n, _, _ in sites64]
    assert names == [n._forward_cls.__name__ for n, _, _ in sites32] \
        == [n._forward_cls.__name__ for n, _, _ in sitescpu], "the graphs differ"
    print(f"== {family}", file=log)
    rows = []
    for k, name in enumerate(names):
        (n64, go64, gi64), (n32, go32, gi32), (nc, goc, gic) = sites64[k], sites32[k], sitescpu[k]
        pairs = [(a, b) for a, b in zip(gi32, gi64) if b is not None]
        if not pairs:
            continue
        e_in = rel_err(go32[0], go64[0])
        e_out = max(rel_err(a, b) for a, b in pairs)
        e_out_cpu = max(rel_err(a, b) for a, b in zip(gic, gi64) if b is not None)
        line = (f"  {k:3d} {name:18s} {where(n32, nodes32)}: received {e_in:.3e} "
                f"returned {e_out:.3e} "
                f"(CPU returned {e_out_cpu:.3e})")
        den = None
        if name in DENOMINATORS:
            den = worst_denominator(name, (n32, n64, nc), go64[0])
            line += (f"; worst denominator element {den[1]}: float64 {den[2]:.6e}, card "
                     f"{den[3]:.6e}, CPU {den[4]:.6e} (card's relative error {den[0]:.3e})")
        print(line, file=log)
        rows.append((e_out / max(e_in, 1e-300), k, name, e_in, e_out, e_out_cpu, den))
    log.flush()
    e_card, e_cpu = rel_err(card32, card64), rel_err(cpu32, card64)
    print(f"{family} float32 L{cfg.num_layers} B1x{ids.shape[1]} {comp.name}: map against "
          f"float64 on the card: card {e_card:.3e}, host CPU {e_cpu:.3e}; {len(names)} sites",
          flush=True)
    rows.sort(key=lambda r: -r[0])
    for growth, k, name, e_in, e_out, e_out_cpu, den in rows[:3]:
        print(f"  site {k} {name} at {where(sites32[k][0], nodes32)}: received {e_in:.3e}, "
              f"returned {e_out:.3e} (x{growth:.1f}; "
              f"the CPU's returned {e_out_cpu:.3e})"
              + (f", worst denominator float64 {den[2]:.6e} card {den[3]:.6e} (relative "
                 f"error {den[0]:.3e})" if den else ""), flush=True)
    growth, k, name, _, _, _, den = rows[0]
    if name in EDITABLE:
        out = sites32[k][0].saved_tensors[2]
        want = sites64[k][0].saved_tensors[2].flatten()[den[1]]
        out.data.view(-1)[den[1]] = want.to(out.dtype)   # .data: the saved copy is kept
        fixed = again()
        print(f"  counterfactual: the card's float32 backward with site {k}'s element "
              f"{den[1]} at its float64 value: map against float64 {rel_err(fixed, card64):.3e} "
              f"(was {e_card:.3e})", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("explicit_float32_sites: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    families = ["bert", "llama", "gpt2"]
    if "--families" in sys.argv:
        families = sys.argv[sys.argv.index("--families") + 1].split(",")
    table = sys.argv[sys.argv.index("--table") + 1] if "--table" in sys.argv else os.devnull
    with open(table, "w") as log:
        for family in families:
            t0 = time.perf_counter()
            family_sites(family, log)
            torch.cuda.empty_cache()
            print(f"  ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
