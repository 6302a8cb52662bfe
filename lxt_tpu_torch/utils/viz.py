"""Token-heatmap rendering and tokenizer cleanup (a copy of
``lxt_tpu/utils/viz.py``, which imports no JAX).

Parity with the reference's ``lxt/utils.py``: ``pdf_heatmap`` (LaTeX
colorbox document compiled via xelatex/pdflatex) and ``clean_tokens``
(SentencePiece/BPE/WordPiece marker handling + LaTeX escaping). Adds an
``html_heatmap`` renderer with the same colormap for hosts without a LaTeX
toolchain. Relevances may be tensors, arrays or lists: every value goes
through ``float()``.
"""

import html as _html
import os
import subprocess
from pathlib import Path


def _bwr(value):
    """matplotlib 'bwr'-equivalent colormap on [-1, 1] -> (r, g, b) bytes.

    bwr linearly blends blue (0,0,255) -> white (255,255,255) -> red
    (255,0,0); implemented directly to avoid importing matplotlib on the
    hot path (identical output to cm.bwr for these anchor points).
    """
    v = max(-1.0, min(1.0, float(value)))
    if v < 0:
        t = 1.0 + v  # 0 at -1, 1 at 0
        return int(round(255 * t)), int(round(255 * t)), 255
    t = 1.0 - v
    return 255, int(round(255 * t)), int(round(255 * t))


def _colormap(value, cmap="bwr"):
    if cmap == "bwr":
        return _bwr(value)
    # fall back to matplotlib for other colormaps
    import matplotlib
    import matplotlib.colors as colors
    rgba = matplotlib.colormaps[cmap](
        colors.Normalize(vmin=-1, vmax=1)(float(value)))
    return tuple(int(c * 255) for c in rgba[:3])


def clean_tokens(words):
    """Strip tokenizer markers and escape LaTeX-special characters.

    Handles SentencePiece (U+2581), byte-BPE (Ġ) and WordPiece (##) schemes,
    mirroring the reference's behavior (lxt/utils.py:95-119) including the
    ValueError on unrecognized schemes.
    """
    words = list(words)
    if any("▁" in w for w in words):
        words = [w.replace("▁", " ") for w in words]
    elif any("Ġ" in w for w in words):
        words = [w.replace("Ġ", " ") for w in words]
    elif any("##" in w for w in words):
        words = [w.replace("##", "") if "##" in w else " " + w for w in words]
        words[0] = words[0].strip()
    else:
        raise ValueError("The tokenization scheme is not recognized.")

    for ch in ["\\", "&", "%", "$", "#", "_", "{", "}"]:
        words = [w.replace(ch, "\\" + ch) if ch in w else w for w in words]
    return words


def _latex_doc(words, relevances, cmap="bwr"):
    lines = [
        r"\documentclass[varwidth=200mm]{standalone}",
        r"\usepackage[dvipsnames]{xcolor}",
        r"\begin{document}",
        r"\fbox{\parbox{\textwidth}{\setlength\fboxsep{0pt}",
    ]
    body = []
    for word, rel in zip(words, relevances):
        r, g, b = _colormap(rel, cmap)
        sep = " " if word.startswith(" ") else ""
        body.append(
            f"{sep}\\colorbox[RGB]{{{r},{g},{b}}}{{\\strut {word}}}")
    lines.append("".join(body))
    lines.append(r"}}\end{document}")
    return "\n".join(lines)


def pdf_heatmap(words, relevances, cmap="bwr", path="heatmap.pdf",
                delete_aux_files=True, backend="xelatex"):
    """Render per-token relevances in [-1, 1] as a colorbox PDF via LaTeX.

    Same contract as the reference (lxt/utils.py:68-92). If the LaTeX binary
    is unavailable, falls back to writing an HTML heatmap next to ``path``
    and raises FileNotFoundError only if that also fails.
    """
    words = list(words)
    rels = [float(r) for r in relevances]
    assert len(words) == len(rels), "The number of words and relevances must be the same."
    assert min(rels) >= -1 and max(rels) <= 1, \
        "The relevances must be normalized between -1 and 1."

    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)

    from shutil import which
    if which(backend) is None:
        alt = html_heatmap(words, rels, cmap=cmap,
                           path=path.with_suffix(".html"))
        print(f"LaTeX backend '{backend}' not found; wrote {alt} instead.")
        return alt

    tex = path.with_suffix(".tex")
    tex.write_text(_latex_doc(words, rels, cmap))
    # nonstopmode: on a LaTeX error the default errorstopmode prompts on
    # stdin, which hangs interactive sessions.
    ret = subprocess.call([backend, "-interaction=nonstopmode",
                           "--output-directory", str(path.parent), str(tex)])
    if ret != 0 or not path.exists():
        alt = html_heatmap(words, rels, cmap=cmap,
                           path=path.with_suffix(".html"))
        print(f"'{backend}' failed (exit {ret}); wrote {alt} instead "
              f"(kept {tex} for inspection).")
        return alt
    if delete_aux_files:
        for suffix in (".aux", ".log", ".tex"):
            p = path.with_suffix(suffix)
            if p.exists():
                p.unlink()
    return path


def html_heatmap(words, relevances, cmap="bwr", path="heatmap.html"):
    """Self-contained HTML token heatmap (no external toolchain)."""
    words = list(words)
    rels = [float(r) for r in relevances]
    assert len(words) == len(rels)

    spans = []
    for word, rel in zip(words, rels):
        r, g, b = _colormap(rel, cmap)
        spans.append(
            f'<span style="background-color: rgb({r},{g},{b});'
            f' padding:1px 0;" title="{rel:+.4f}">'
            f"{_html.escape(word)}</span>")
    doc = ("<!doctype html><meta charset='utf-8'>"
           "<body style=\"font-family: monospace; line-height: 1.6;"
           " max-width: 60em; margin: 2em auto;\">"
           + "".join(spans) + "</body>")
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    path.write_text(doc)
    return path


def html_response_heatmap(tokens, response_tokens, relevance,
                          cmap="bwr", path="response_heatmap.html"):
    """Response-attribution matrix as one self-contained HTML table.

    ``tokens``: the full sequence (prompt + response, the Heatmaps'
    ``.tokens``); ``response_tokens``: the K generated tokens (row
    labels); ``relevance``: ``[K, len(tokens)]`` — row k is the map
    explaining why ``response_tokens[k]`` was generated (e.g. stacked
    ``ResponseAttribution.heatmaps[k].relevance``). Rows are normalized
    independently to [-1, 1]. Cells carry the raw value as a tooltip.
    """
    tokens = [str(t) for t in tokens]
    K = len(response_tokens)
    rows = []
    for k in range(K):
        row = [float(r) for r in relevance[k]]
        if len(row) != len(tokens):
            raise ValueError(
                f"relevance row {k} has {len(row)} entries for "
                f"{len(tokens)} tokens")
        denom = max(abs(r) for r in row) or 1.0
        cells = []
        for tok, rel in zip(tokens, row):
            r, g, b = _colormap(rel / denom, cmap)
            cells.append(
                f'<td style="background-color: rgb({r},{g},{b});'
                f' padding:1px 4px;" title="{rel:+.4f}">'
                f"{_html.escape(tok)}</td>")
        label = _html.escape(str(response_tokens[k]))
        rows.append(f'<tr><th style="text-align:right; padding-right:'
                    f'8px;">{label}</th>{"".join(cells)}</tr>')
    doc = ("<!doctype html><meta charset='utf-8'>"
           "<body style=\"font-family: monospace; line-height: 1.6;"
           " margin: 2em;\">"
           "<p>row k: why the model generated that token "
           "(red = supports, blue = contradicts)</p>"
           '<table style="border-collapse: collapse;">'
           + "".join(rows) + "</table></body>")
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    path.write_text(doc)
    return path
