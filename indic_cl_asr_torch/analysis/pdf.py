"""A small vector-PDF figure writer for the results report.

Panels with line series and markers, shaded bands, error bars, box plots,
a horizontal rule, ticks, titles and legends, written as one-page PDFs in
the viewer's built-in Helvetica, so the report needs numpy alone (no
plotting library). Series take the tab10 colours in turn, as a plotting
library's default cycle does.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

TAB10 = ((0.122, 0.467, 0.706), (1.0, 0.498, 0.055), (0.173, 0.627, 0.173),
         (0.839, 0.153, 0.157), (0.580, 0.404, 0.741), (0.549, 0.337, 0.294),
         (0.890, 0.467, 0.761), (0.498, 0.498, 0.498), (0.737, 0.741, 0.133),
         (0.090, 0.745, 0.812))
GRID = (0.85, 0.85, 0.85)
BLACK = (0.0, 0.0, 0.0)


def color(i: int):
    return TAB10[i % len(TAB10)]


def _esc(text: str) -> str:
    text = str(text).encode("latin-1", "replace").decode("latin-1")
    return text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _num(v: float) -> str:
    return f"{v:.2f}"


def nice_ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    span = (hi - lo) or 1.0
    step = 10.0 ** math.floor(math.log10(span / n))
    for m in (1, 2, 5, 10):
        if span / (step * m) <= n:
            step *= m
            break
    first = math.ceil(lo / step - 1e-9) * step
    return [round(first + k * step, 12) for k in range(int((hi - first) / step + 1e-9) + 1)]


class Canvas:
    """PDF drawing operators in points, origin bottom left."""

    def __init__(self):
        self.ops: list[str] = []

    def _stroke(self, rgb, width):
        self.ops.append(f"{' '.join(_num(c) for c in rgb)} RG {_num(width)} w")

    def polyline(self, pts, rgb=BLACK, width=1.0):
        if len(pts) < 2:
            return
        self._stroke(rgb, width)
        path = " ".join(f"{_num(x)} {_num(y)} {'m' if i == 0 else 'l'}"
                        for i, (x, y) in enumerate(pts))
        self.ops.append(path + " S")

    def polygon(self, pts, rgb, stroke=None):
        self.ops.append(f"{' '.join(_num(c) for c in rgb)} rg")
        path = " ".join(f"{_num(x)} {_num(y)} {'m' if i == 0 else 'l'}"
                        for i, (x, y) in enumerate(pts))
        if stroke is None:
            self.ops.append(path + " h f")
        else:
            self._stroke(stroke, 0.8)
            self.ops.append(path + " h B")

    def marker(self, x, y, rgb, shape="o", r=2.5):
        if shape == "s":
            self.polygon([(x - r, y - r), (x + r, y - r), (x + r, y + r), (x - r, y + r)], rgb)
            return
        k = 0.5523 * r  # a circle as four Bezier arcs
        self.ops.append(
            f"{' '.join(_num(c) for c in rgb)} rg {_num(x + r)} {_num(y)} m "
            f"{_num(x + r)} {_num(y + k)} {_num(x + k)} {_num(y + r)} {_num(x)} {_num(y + r)} c "
            f"{_num(x - k)} {_num(y + r)} {_num(x - r)} {_num(y + k)} {_num(x - r)} {_num(y)} c "
            f"{_num(x - r)} {_num(y - k)} {_num(x - k)} {_num(y - r)} {_num(x)} {_num(y - r)} c "
            f"{_num(x + k)} {_num(y - r)} {_num(x + r)} {_num(y - k)} {_num(x + r)} {_num(y)} c f")

    def text(self, x, y, s, size=8.0, anchor="left", angle=0.0):
        width = 0.5 * size * len(str(s))  # Helvetica's mean advance, roughly
        shift = {"left": 0.0, "center": width / 2, "right": width}[anchor]
        c, s_ = math.cos(math.radians(angle)), math.sin(math.radians(angle))
        x, y = x - shift * c, y - shift * s_
        self.ops.append(f"BT /F1 {_num(size)} Tf 0 0 0 rg {_num(c)} {_num(s_)} {_num(-s_)} "
                        f"{_num(c)} {_num(x)} {_num(y)} Tm ({_esc(s)}) Tj ET")

    def save(self, path: str, width: float, height: float) -> None:
        stream = zlib.compress("\n".join(self.ops).encode("latin-1"))
        objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
                b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
                (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_num(width)} {_num(height)}] "
                 "/Resources << /Font << /F1 4 0 R >> >> /Contents 5 0 R >>").encode(),
                b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
                b"/Encoding /WinAnsiEncoding >>",
                f"<< /Length {len(stream)} /Filter /FlateDecode >>\nstream\n".encode()
                + stream + b"\nendstream"]
        out, offsets = bytearray(b"%PDF-1.4\n"), []
        for i, body in enumerate(objs, 1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref = len(out)
        out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
        out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
        out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
                f"startxref\n{xref}\n%%EOF\n").encode()
        with open(path, "wb") as f:
            f.write(bytes(out))


class Axes:
    """One panel: collects series, then draws them into a box."""

    def __init__(self):
        self.items: list[tuple] = []
        self.title = self.xlabel = self.ylabel = ""
        self.xticks: tuple[list, list] | None = None
        self.xtick_angle = 0.0
        self.legend_entries: list[tuple[str, tuple, str]] | None = None
        self.grid = False
        self._n = 0

    def _next_color(self, rgb):
        if rgb is None:
            rgb, self._n = color(self._n), self._n + 1
        return rgb

    def plot(self, x, y, label=None, marker="o", rgb=None):
        self.items.append(("line", np.asarray(x, float), np.asarray(y, float),
                           self._next_color(rgb), label, marker))

    def fill_between(self, x, lo, hi, alpha=0.2):
        """A band in the last series' colour, blended with white."""
        rgb = color(max(self._n - 1, 0))
        pale = tuple(1.0 - alpha * (1.0 - c) for c in rgb)
        self.items.append(("band", np.asarray(x, float), np.asarray(lo, float),
                           np.asarray(hi, float), pale))

    def errorbar(self, x, y, lower, upper, label=None, rgb=None):
        y = np.asarray(y, float)
        self.items.append(("errbar", np.asarray(x, float), y, y - np.asarray(lower, float),
                           y + np.asarray(upper, float), self._next_color(rgb), label))

    def boxplot(self, data, positions, colors, widths=0.6):
        for vals, pos, rgb in zip(data, positions, colors):
            v = np.asarray(vals, float)
            v = v[np.isfinite(v)]
            if v.size:
                self.items.append(("box", float(pos), v, widths, rgb))

    def axhline(self, y):
        self.items.append(("hline", float(y)))

    def set_xticks(self, ticks, labels=None, angle=0.0):
        ticks = [float(t) for t in ticks]
        self.xticks = (ticks, [str(l) for l in labels] if labels is not None
                       else [f"{t:g}" for t in ticks])
        self.xtick_angle = angle

    def legend(self, entries=None):
        """``entries``: [(label, rgb, marker)]; by default every labelled
        series."""
        if entries is None:
            entries = [(it[4], it[3], it[5]) for it in self.items if it[0] == "line" and it[4]]
            entries += [(it[6], it[5], "o") for it in self.items if it[0] == "errbar" and it[6]]
        self.legend_entries = entries

    def _limits(self):
        xs, ys = [], []
        for it in self.items:
            kind = it[0]
            if kind == "line":
                xs.append(it[1])
                ys.append(it[2])
            elif kind == "band":
                xs.append(it[1])
                ys.extend([it[2], it[3]])
            elif kind == "errbar":
                xs.append(it[1])
                ys.extend([it[3], it[4]])
            elif kind == "box":
                xs.append(np.array([it[1] - it[3], it[1] + it[3]]))
                ys.append(it[2])
            elif kind == "hline":
                ys.append(np.array([it[1]]))
        if self.xticks:
            xs.append(np.array(self.xticks[0]))

        def span(arrs):
            v = np.concatenate([a.ravel() for a in arrs]) if arrs else np.zeros(0)
            v = v[np.isfinite(v)]
            if not v.size:
                return 0.0, 1.0
            lo, hi = float(v.min()), float(v.max())
            pad = 0.05 * (hi - lo) if hi > lo else 0.5
            return lo - pad, hi + pad

        return span(xs), span(ys)

    def draw(self, cv: Canvas, x0, y0, w, h):
        (xl, xh), (yl, yh) = self._limits()
        X = lambda v: x0 + (v - xl) / (xh - xl) * w  # noqa: E731
        Y = lambda v: y0 + (v - yl) / (yh - yl) * h  # noqa: E731
        yticks = [t for t in nice_ticks(yl, yh) if yl <= t <= yh]
        if self.xticks:
            xticks, xlabels = self.xticks
        else:
            xticks = [v for v in nice_ticks(xl, xh) if xl <= v <= xh]
            xlabels = [f"{v:g}" for v in xticks]
        if self.grid:
            for t in yticks:
                cv.polyline([(x0, Y(t)), (x0 + w, Y(t))], GRID, 0.5)
            for t in xticks:
                cv.polyline([(X(t), y0), (X(t), y0 + h)], GRID, 0.5)
        for it in self.items:
            kind = it[0]
            if kind == "band":
                _, x, lo, hi, rgb = it
                ok = np.isfinite(x) & np.isfinite(lo) & np.isfinite(hi)
                if ok.sum() >= 2:
                    pts = [(X(a), Y(b)) for a, b in zip(x[ok], lo[ok])]
                    pts += [(X(a), Y(b)) for a, b in zip(x[ok][::-1], hi[ok][::-1])]
                    cv.polygon(pts, rgb)
            elif kind == "hline":
                cv.polyline([(x0, Y(it[1])), (x0 + w, Y(it[1]))], (0.5, 0.5, 0.5), 0.5)
        for it in self.items:
            kind = it[0]
            if kind == "line":
                _, x, y, rgb, _, marker = it
                seg = []
                for a, b in zip(x, y):
                    if np.isfinite(a) and np.isfinite(b):
                        seg.append((X(a), Y(b)))
                    else:
                        cv.polyline(seg, rgb, 1.2)
                        seg = []
                cv.polyline(seg, rgb, 1.2)
                for a, b in zip(x, y):
                    if np.isfinite(a) and np.isfinite(b):
                        cv.marker(X(a), Y(b), rgb, marker)
            elif kind == "errbar":
                _, x, y, lo, hi, rgb, _ = it
                for a, b, l, u in zip(x, y, lo, hi):
                    if np.isfinite(a) and np.isfinite(l) and np.isfinite(u):
                        cv.polyline([(X(a), Y(l)), (X(a), Y(u))], rgb, 1.0)
                        for v in (l, u):
                            cv.polyline([(X(a) - 3, Y(v)), (X(a) + 3, Y(v))], rgb, 1.0)
                ok = np.isfinite(x) & np.isfinite(y)
                cv.polyline([(X(a), Y(b)) for a, b in zip(x[ok], y[ok])], rgb, 1.2)
                for a, b in zip(x[ok], y[ok]):
                    cv.marker(X(a), Y(b), rgb, "o")
            elif kind == "box":
                _, pos, v, width, rgb = it
                q1, med, q3 = np.percentile(v, [25, 50, 75])
                iqr = q3 - q1
                lo = v[v >= q1 - 1.5 * iqr].min()
                hi = v[v <= q3 + 1.5 * iqr].max()
                half = width / 2
                cv.polyline([(X(pos), Y(lo)), (X(pos), Y(q1))], BLACK, 0.8)
                cv.polyline([(X(pos), Y(q3)), (X(pos), Y(hi))], BLACK, 0.8)
                for v_ in (lo, hi):
                    cv.polyline([(X(pos - half / 2), Y(v_)), (X(pos + half / 2), Y(v_))],
                                BLACK, 0.8)
                cv.polygon([(X(pos - half), Y(q1)), (X(pos + half), Y(q1)),
                            (X(pos + half), Y(q3)), (X(pos - half), Y(q3))], rgb, BLACK)
                cv.polyline([(X(pos - half), Y(med)), (X(pos + half), Y(med))],
                            (1.0, 0.498, 0.055), 1.2)
                cv.marker(X(pos), Y(float(v.mean())), (0.173, 0.627, 0.173), "s", 2.0)
        cv.polyline([(x0, y0), (x0 + w, y0), (x0 + w, y0 + h), (x0, y0 + h), (x0, y0)],
                    BLACK, 0.8)
        for t in yticks:
            cv.polyline([(x0 - 3, Y(t)), (x0, Y(t))], BLACK, 0.8)
            cv.text(x0 - 5, Y(t) - 2.5, f"{t:g}", 7, "right")
        for t, lab in zip(xticks, xlabels):
            cv.polyline([(X(t), y0 - 3), (X(t), y0)], BLACK, 0.8)
            if self.xtick_angle:
                cv.text(X(t), y0 - 8, lab, 7, "right", self.xtick_angle)
            else:
                cv.text(X(t), y0 - 12, lab, 7, "center")
        cv.text(x0 + w / 2, y0 + h + 6, self.title, 9, "center")
        cv.text(x0 + w / 2, y0 - 30, self.xlabel, 8, "center")
        cv.text(x0 - 34, y0 + h / 2, self.ylabel, 8, "center", 90.0)
        for k, (label, rgb, marker) in enumerate(self.legend_entries or []):
            ly = y0 + h - 10 - 10 * k
            cv.marker(x0 + w - 90, ly + 2.5, rgb, marker)
            cv.text(x0 + w - 84, ly, label, 6)


class Figure:
    """A grid of ``nrows`` x ``ncols`` panels on one page of ``size``
    inches, with an optional title over them."""

    def __init__(self, nrows: int = 1, ncols: int = 1, size=(6.0, 4.0)):
        self.nrows, self.ncols = nrows, ncols
        self.width, self.height = 72.0 * size[0], 72.0 * size[1]
        self.axes = [[Axes() for _ in range(ncols)] for _ in range(nrows)]
        self.title = ""

    def flat(self) -> list[Axes]:
        return [ax for row in self.axes for ax in row]

    def save(self, path: str) -> None:
        cv = Canvas()
        top = 24.0 if self.title else 8.0
        cell_w = self.width / self.ncols
        cell_h = (self.height - top) / self.nrows
        for r, row in enumerate(self.axes):
            for c, ax in enumerate(row):
                x0 = c * cell_w + 48
                y0 = self.height - top - (r + 1) * cell_h + 44
                if ax.items:
                    ax.draw(cv, x0, y0, cell_w - 60, cell_h - 64)
        if self.title:
            cv.text(self.width / 2, self.height - 16, self.title, 11, "center")
        cv.save(path, self.width, self.height)
