"""Self-contained HTML chart rendering (the reference uses the `charming`
crate to emit echarts HTML, writers.rs:692+ SampledProbs histograms and
localise/util.rs:86 get_plot). This environment has no CDN access, so the
charts render as static inline SVG with the series data also embedded as a
machine-readable JSON block (<script type="application/json" id="data">),
keeping the document dependency-free while remaining parseable."""

from __future__ import annotations

import html as _html
import json

# reference color anchors (mod_base_code.rs:94-102)
MOD_COLORS = {"m": "#FF0000", "h": "#FF00FF", "a": "#0084A9"}
DNA_BASE_COLORS = {"C": "#0000FF", "A": "#009600"}
_FALLBACK = ("#E69F00", "#56B4E9", "#009E73", "#CC79A7", "#D55E00", "#0072B2")

W, H = 800, 800
ML, MR, MT, MB = 70, 30, 60, 120  # margins


def series_color(label: str, i: int, overrides: dict | None = None) -> str:
    """base:state label -> reference color, else a stable fallback.

    ``overrides`` = {"dna": {base: color}, "mod": {code: color}} from
    --dna-color/--mod-color (commands.rs:619-625 primary_base_colors /
    mod_base_colors)."""
    dna = dict(DNA_BASE_COLORS)
    mod = dict(MOD_COLORS)
    if overrides:
        dna.update(overrides.get("dna") or {})
        mod.update(overrides.get("mod") or {})
    if ":" in label:
        base, state = label.split(":", 1)
        if state == "-":
            if base in dna:
                return dna[base]
        elif state in mod:
            return mod[state]
    elif label in mod:
        return mod[label]
    return _FALLBACK[i % len(_FALLBACK)]


def _doc(title: str, body: str, payload) -> str:
    return (
        "<!DOCTYPE html>\n<html>\n<head>\n"
        f"<meta charset=\"utf-8\"/>\n<title>{_html.escape(title)}</title>\n"
        "</head>\n<body>\n"
        f"<script type=\"application/json\" id=\"data\">"
        f"{json.dumps(payload)}</script>\n"
        f"{body}\n</body>\n</html>\n"
    )


def _legend(labels_colors, y0: int) -> list[str]:
    out = []
    x = ML
    for label, color in labels_colors:
        out.append(
            f'<rect x="{x}" y="{y0}" width="12" height="12" fill="{color}"/>'
        )
        out.append(
            f'<text x="{x + 16}" y="{y0 + 11}" font-size="12" '
            f'font-family="sans-serif">{_html.escape(label)}</text>'
        )
        x += 16 + 8 * len(label) + 24
    return out


def bar_chart_html(
    title: str,
    categories: list[str],
    series: list[tuple[str, list]],
    y_name: str,
    color_overrides: dict | None = None,
) -> str:
    """Grouped bar chart: one group per category, one bar per series
    (SampledProbs counts.html / proportion.html, writers.rs:966-985)."""
    payload = {
        "title": title,
        "x_categories": categories,
        "y_name": y_name,
        "series": [
            {"name": n, "data": [float(v) for v in vals]}
            for n, vals in series
        ],
    }
    n_cat = max(len(categories), 1)
    n_ser = max(len(series), 1)
    vmax = max(
        (float(v) for _, vals in series for v in vals), default=1.0
    ) or 1.0
    plot_w, plot_h = W - ML - MR, H - MT - MB
    group_w = plot_w / n_cat
    bar_w = max(group_w * 0.8 / n_ser, 0.5)
    colors = [
        series_color(n, i, color_overrides)
        for i, (n, _) in enumerate(series)
    ]
    el = [
        f'<text x="{W // 2}" y="24" text-anchor="middle" font-size="16" '
        f'font-family="sans-serif">{_html.escape(title)}</text>'
    ]
    el += _legend(list(zip([n for n, _ in series], colors)), 32)
    # axes
    el.append(
        f'<line x1="{ML}" y1="{MT}" x2="{ML}" y2="{MT + plot_h}" '
        'stroke="black"/>'
    )
    el.append(
        f'<line x1="{ML}" y1="{MT + plot_h}" x2="{ML + plot_w}" '
        f'y2="{MT + plot_h}" stroke="black"/>'
    )
    el.append(
        f'<text x="16" y="{MT + plot_h // 2}" font-size="12" '
        f'transform="rotate(-90 16 {MT + plot_h // 2})" '
        f'font-family="sans-serif">{_html.escape(y_name)}</text>'
    )
    for t in range(5):
        yv = vmax * t / 4
        y = MT + plot_h - plot_h * t / 4
        el.append(
            f'<text x="{ML - 6}" y="{y + 4:.1f}" text-anchor="end" '
            f'font-size="10" font-family="sans-serif">{yv:.4g}</text>'
        )
    for si, (name, vals) in enumerate(series):
        for ci, v in enumerate(vals):
            bh = plot_h * float(v) / vmax
            x = ML + ci * group_w + group_w * 0.1 + si * bar_w
            el.append(
                f'<rect x="{x:.2f}" y="{MT + plot_h - bh:.2f}" '
                f'width="{bar_w:.2f}" height="{bh:.2f}" '
                f'fill="{colors[si]}"><title>'
                f"{_html.escape(name)} {_html.escape(str(categories[ci]))}: "
                f"{v}</title></rect>"
            )
    step = max(n_cat // 16, 1)
    for ci in range(0, n_cat, step):
        x = ML + ci * group_w + group_w / 2
        el.append(
            f'<text x="{x:.1f}" y="{MT + plot_h + 14}" font-size="9" '
            f'transform="rotate(45 {x:.1f} {MT + plot_h + 14})" '
            f'font-family="sans-serif">{_html.escape(categories[ci])}</text>'
        )
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
        f'viewBox="0 0 {W} {H}">' + "".join(el) + "</svg>"
    )
    return _doc(title, svg, payload)


def line_chart_html(
    title: str,
    series: list[tuple[str, list[tuple[float, float]]]],
    x_name: str,
    y_name: str,
    color_overrides: dict | None = None,
) -> str:
    """Line chart of (x, y) series (localize --chart,
    localise/util.rs:86-155: percent modified by offset per mod code)."""
    payload = {
        "title": title,
        "x_name": x_name,
        "y_name": y_name,
        "series": [
            {"name": n, "data": [[float(x), float(y)] for x, y in pts]}
            for n, pts in series
        ],
    }
    xs = [x for _, pts in series for x, _ in pts]
    ys = [y for _, pts in series for _, y in pts]
    x0, x1 = (min(xs), max(xs)) if xs else (0.0, 1.0)
    y0, y1 = (min(ys + [0.0]), max(ys)) if ys else (0.0, 1.0)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y1 = y0 + 1
    plot_w, plot_h = W - ML - MR, H - MT - MB

    def sx(x):
        return ML + (x - x0) / (x1 - x0) * plot_w

    def sy(y):
        return MT + plot_h - (y - y0) / (y1 - y0) * plot_h

    colors = [
        series_color(n, i, color_overrides)
        for i, (n, _) in enumerate(series)
    ]
    el = [
        f'<text x="{W // 2}" y="24" text-anchor="middle" font-size="16" '
        f'font-family="sans-serif">{_html.escape(title)}</text>'
    ]
    el += _legend(list(zip([n for n, _ in series], colors)), 32)
    el.append(
        f'<line x1="{ML}" y1="{MT}" x2="{ML}" y2="{MT + plot_h}" '
        'stroke="black"/>'
    )
    el.append(
        f'<line x1="{ML}" y1="{MT + plot_h}" x2="{ML + plot_w}" '
        f'y2="{MT + plot_h}" stroke="black"/>'
    )
    el.append(
        f'<text x="{ML + plot_w // 2}" y="{H - 70}" text-anchor="middle" '
        f'font-size="12" font-family="sans-serif">{_html.escape(x_name)}</text>'
    )
    el.append(
        f'<text x="16" y="{MT + plot_h // 2}" font-size="12" '
        f'transform="rotate(-90 16 {MT + plot_h // 2})" '
        f'font-family="sans-serif">{_html.escape(y_name)}</text>'
    )
    for t in range(5):
        yv = y0 + (y1 - y0) * t / 4
        xv = x0 + (x1 - x0) * t / 4
        el.append(
            f'<text x="{ML - 6}" y="{sy(yv) + 4:.1f}" text-anchor="end" '
            f'font-size="10" font-family="sans-serif">{yv:.4g}</text>'
        )
        el.append(
            f'<text x="{sx(xv):.1f}" y="{MT + plot_h + 16}" '
            f'text-anchor="middle" font-size="10" '
            f'font-family="sans-serif">{xv:.5g}</text>'
        )
    for i, (name, pts) in enumerate(series):
        if not pts:
            continue
        d = " ".join(f"{sx(x):.2f},{sy(y):.2f}" for x, y in sorted(pts))
        el.append(
            f'<polyline points="{d}" fill="none" stroke="{colors[i]}" '
            f'stroke-width="1.5"><title>{_html.escape(name)}</title>'
            "</polyline>"
        )
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
        f'viewBox="0 0 {W} {H}">' + "".join(el) + "</svg>"
    )
    return _doc(title, svg, payload)
