"""ConvergenceTable-style text reporting (parity with
dealii::ConvergenceTable usage in advection-convergence.cc:212-218).

Port of gdm/io/tables.py, verbatim."""

from __future__ import annotations


class ConvergenceTable:
    def __init__(self):
        self.columns = {}
        self.order = []
        self.scientific = set()
        self.n_rows = 0

    def add_value(self, key: str, value):
        if key not in self.columns:
            self.columns[key] = []
            self.order.append(key)
        self.columns[key].append(value)
        self.n_rows = max(self.n_rows, len(self.columns[key]))

    def set_scientific(self, key: str, flag: bool = True):
        if flag:
            self.scientific.add(key)
        else:
            self.scientific.discard(key)

    def clear(self):
        self.columns = {}
        self.order = []
        self.n_rows = 0

    def _fmt(self, key, v):
        if isinstance(v, int):
            return str(v)
        if key in self.scientific:
            return f"{v:.4e}"
        return f"{v:.4f}"

    def write_text(self, out=None) -> str:
        import sys

        rows = []
        widths = {}
        for k in self.order:
            cells = [self._fmt(k, v) for v in self.columns[k]]
            widths[k] = max(len(k), max((len(c) for c in cells), default=0))
        header = " ".join(k.ljust(widths[k]) for k in self.order)
        rows.append(header)
        for i in range(self.n_rows):
            rows.append(" ".join(
                self._fmt(k, self.columns[k][i]).rjust(widths[k])
                for k in self.order))
        text = "\n".join(rows) + "\n"
        if out is None:
            sys.stdout.write(text)
        else:
            out.write(text)
        return text
