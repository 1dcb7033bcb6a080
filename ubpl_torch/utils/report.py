"""Run reporting (reference CommUtils xlsx dumps,
utils/base/comm.py:105-173, dormant): the port's copy of
``ubpl_tpu/utils/report.py``.

The reference writes conditional-formatted .xlsx sheets via openpyxl (a
dependency the port does not take).  Equivalent surface: collect per-epoch metric rows and
emit CSV and markdown tables, with the "conditional formatting" expressed as
a best-row marker column.
"""
import csv
import os


class RunReport:
    def __init__(self, columns):
        self.columns = list(columns)
        self.rows = []

    def add_row(self, **values):
        self.rows.append([values.get(c, "") for c in self.columns])

    def best_row_idx(self, column, maximize=True):
        col = self.columns.index(column)
        vals = [(r[col], i) for i, r in enumerate(self.rows)
                if isinstance(r[col], (int, float))]
        if not vals:
            return -1
        return (max(vals)[1] if maximize else min(vals)[1])

    def to_csv(self, path, highlight_column=None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        best = (self.best_row_idx(highlight_column)
                if highlight_column else -1)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.columns + ["best"])
            for i, r in enumerate(self.rows):
                w.writerow(r + ["*" if i == best else ""])

    def to_markdown(self, path=None, highlight_column=None):
        best = (self.best_row_idx(highlight_column)
                if highlight_column else -1)
        lines = ["| " + " | ".join(self.columns) + " |",
                 "|" + "---|" * len(self.columns)]
        for i, r in enumerate(self.rows):
            cells = [f"**{c}**" if i == best else str(c) for c in r]
            lines.append("| " + " | ".join(cells) + " |")
        text = "\n".join(lines)
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def to_xlsx(self, path, highlight_column=None):
        """Reference xlsx artifact (CommUtils.xlsx_save): one sheet with the
        best cell of `highlight_column` solid-filled."""
        from .xlsx import write_xlsx
        highlight = None
        if highlight_column:
            i = self.best_row_idx(highlight_column)
            if i >= 0:
                highlight = (i, self.columns.index(highlight_column))
        write_xlsx(path, self.columns, self.rows, highlight=highlight)
