"""Multi-run result collector.

Port of ``dmfusion/report/collect.py``: it scans a results root for the
``<model>__<N>_result.xlsx`` workbooks the solvers write
(``report/excel.py::expo_result``), pulls each repeat's OA/AA/KAPPA block
and writes one ``summary.xlsx``: a row per (run, repeat), then a row of
each run's means.  The workbooks are read with the port's own
``Workbook.load``, so either package's workbooks collect alike.

CLI:  python -m dmfusion_torch.report.collect [root] [-o summary.xlsx]
"""

from __future__ import annotations

import os
from typing import Iterator

from dmfusion_torch.report.excel import Workbook


def iter_run_workbooks(root: str) -> Iterator[tuple[str, str]]:
    """Yield (run_name, xlsx_path) for every result workbook under root."""
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            if fn.endswith("_result.xlsx"):
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                yield rel[:-len("_result.xlsx")], os.path.join(dirpath, fn)


def read_run_metrics(path: str) -> list[dict]:
    """Extract each repeat block's metrics from one result workbook.

    Blocks live at row offset ``repeat * 8`` with the OA/AA/KAPPA row at
    offset 6 (report/excel.py::expo_result layout, mirroring reference
    kappa.py:87-118)."""
    wb = Workbook.load(path)
    sheet = wb.active
    out = []
    rep = 0
    while True:
        base = rep * 8
        if sheet.cell(6 + base, 2) != "OA":
            break
        out.append({
            "repeat": rep,
            "oa": sheet.cell(6 + base, 3),
            "aa": sheet.cell(6 + base, 5),
            "kappa": sheet.cell(6 + base, 7),
            "train_time": sheet.cell(6 + base, 9),
            "test_time": sheet.cell(6 + base, 11),
        })
        rep += 1
    return out


def collect_results(root: str, out_path: str | None = None) -> str:
    """Aggregate every run under ``root`` into one summary workbook."""
    out_path = out_path or os.path.join(root, "summary.xlsx")
    wb = Workbook()
    sheet = wb.active
    sheet.title = "summary"
    header = ("run", "repeat", "OA", "AA", "KAPPA", "train_s", "test_s")
    for c, name in enumerate(header, start=1):
        sheet.cell(1, c, name)
    row = 2
    for run, path in iter_run_workbooks(root):
        metrics = read_run_metrics(path)
        if not metrics:
            continue
        for m in metrics:
            for c, v in enumerate((run, m["repeat"], m["oa"], m["aa"],
                                   m["kappa"], m["train_time"],
                                   m["test_time"]), start=1):
                sheet.cell(row, c, v)
            row += 1
        n = len(metrics)
        sheet.cell(row, 1, run)
        sheet.cell(row, 2, "mean")
        for c, key in ((3, "oa"), (4, "aa"), (5, "kappa")):
            vals = [m[key] for m in metrics if isinstance(m[key],
                                                          (int, float))]
            if vals:
                sheet.cell(row, c, sum(vals) / len(vals))
        row += 2
    wb.save(out_path)
    return out_path


def main(argv: list[str] | None = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m dmfusion_torch.report.collect",
        description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default="Export_result/")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)
    path = collect_results(args.root, args.out)
    print(path)


if __name__ == "__main__":
    main()
