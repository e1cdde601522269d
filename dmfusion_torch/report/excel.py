"""Self-contained XLSX report writer — a copy of ``dmfusion/report/excel.py``.

It is standard-library code, so the port carries it unchanged in
behaviour: one result block written by either package gives the same
bytes.  No openpyxl is needed.

Writes the same per-repeat result-block layout the reference produces
with openpyxl (indicators/kappa.py:87-118): one 8-row block per repeat at
row offset ``group_num * 8`` holding per-class Overall/Correct/Accuracy
plus OA/AA/KAPPA and train/test wall-clock, and on the first repeat a
``config`` sheet recursively dumping the whole run config
(``print_dict_data``/``print_list_data``, kappa.py:130-158).

An .xlsx file is a zip of XML parts; :class:`Workbook` emits the minimal
SpreadsheetML (inline strings, shared-string-free) that Excel, LibreOffice
and pandas all read, and can re-open its own files so successive repeats
append to the same workbook exactly as the reference's
``load_workbook``-then-append flow does.

Known reference bug fixed here: kappa.py:113 writes the *train* time into
the "Test time(s)" cell; we write the actual test time.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
import zipfile
from typing import Any, Mapping

_XLSX_NS = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"


def _col_letter(col: int) -> str:
    out = ""
    while col > 0:
        col, rem = divmod(col - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _ref(row: int, col: int) -> str:
    return f"{_col_letter(col)}{row}"


_REF_RE = re.compile(r"([A-Z]+)(\d+)")


def _parse_ref(ref: str) -> tuple[int, int]:
    m = _REF_RE.fullmatch(ref)
    letters, row = m.group(1), int(m.group(2))
    col = 0
    for ch in letters:
        col = col * 26 + (ord(ch) - ord("A") + 1)
    return row, col


class Sheet:
    def __init__(self, title: str):
        self.title = title
        self.cells: dict[tuple[int, int], Any] = {}

    def cell(self, row: int, column: int, value: Any = None) -> Any:
        if value is not None:
            self.cells[(row, column)] = value
        return self.cells.get((row, column))

    def _to_xml(self) -> bytes:
        rows: dict[int, list[tuple[int, Any]]] = {}
        for (r, c), v in self.cells.items():
            rows.setdefault(r, []).append((c, v))
        parts = [
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
            f'<worksheet xmlns="{_XLSX_NS}"><sheetData>',
        ]
        for r in sorted(rows):
            parts.append(f'<row r="{r}">')
            for c, v in sorted(rows[r]):
                ref = _ref(r, c)
                if isinstance(v, bool):
                    parts.append(f'<c r="{ref}" t="b"><v>{int(v)}</v></c>')
                elif isinstance(v, (int, float)):
                    parts.append(f'<c r="{ref}"><v>{v!r}</v></c>')
                else:
                    text = (str(v).replace("&", "&amp;").replace("<", "&lt;")
                            .replace(">", "&gt;"))
                    parts.append(
                        f'<c r="{ref}" t="inlineStr"><is>'
                        f'<t xml:space="preserve">{text}</t></is></c>')
            parts.append("</row>")
        parts.append("</sheetData></worksheet>")
        return "".join(parts).encode("utf-8")

    @classmethod
    def _from_xml(cls, title: str, data: bytes) -> "Sheet":
        sheet = cls(title)
        root = ET.fromstring(data)
        ns = {"m": _XLSX_NS}
        for c in root.iter(f"{{{_XLSX_NS}}}c"):
            row, col = _parse_ref(c.get("r"))
            t = c.get("t")
            if t == "inlineStr":
                tnode = c.find("m:is/m:t", ns)
                sheet.cells[(row, col)] = tnode.text or ""
            else:
                vnode = c.find("m:v", ns)
                if vnode is None or vnode.text is None:
                    continue
                text = vnode.text
                if t == "b":
                    sheet.cells[(row, col)] = bool(int(text))
                else:
                    num = float(text)
                    sheet.cells[(row, col)] = int(num) if num.is_integer() else num
        return sheet


class Workbook:
    def __init__(self):
        self.sheets: list[Sheet] = [Sheet("Sheet1")]

    @property
    def active(self) -> Sheet:
        return self.sheets[0]

    def create_sheet(self, title: str) -> Sheet:
        sheet = Sheet(title)
        self.sheets.append(sheet)
        return sheet

    def __getitem__(self, title: str) -> Sheet:
        for s in self.sheets:
            if s.title == title:
                return s
        raise KeyError(title)

    def save(self, path: str | os.PathLike) -> None:
        n = len(self.sheets)
        content_types = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
            '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
            + "".join(
                f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
                'ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
                for i in range(n))
            + "</Types>")
        rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
            "</Relationships>")
        wb_xml = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            f'<workbook xmlns="{_XLSX_NS}" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
            "<sheets>"
            + "".join(
                f'<sheet name="{s.title}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
                for i, s in enumerate(self.sheets))
            + "</sheets></workbook>")
        wb_rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            + "".join(
                f'<Relationship Id="rId{i + 1}" '
                'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
                f'Target="worksheets/sheet{i + 1}.xml"/>'
                for i in range(n))
            + "</Relationships>")
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", content_types)
            z.writestr("_rels/.rels", rels)
            z.writestr("xl/workbook.xml", wb_xml)
            z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
            for i, s in enumerate(self.sheets):
                z.writestr(f"xl/worksheets/sheet{i + 1}.xml", s._to_xml())

    @classmethod
    def load(cls, path: str | os.PathLike) -> "Workbook":
        wb = cls()
        wb.sheets = []
        with zipfile.ZipFile(path) as z:
            root = ET.fromstring(z.read("xl/workbook.xml"))
            names = [el.get("name")
                     for el in root.iter(f"{{{_XLSX_NS}}}sheet")]
            for i, name in enumerate(names):
                wb.sheets.append(
                    Sheet._from_xml(name, z.read(f"xl/worksheets/sheet{i + 1}.xml")))
        return wb


def _dump_dict(data: Mapping, sheet: Sheet, row: int, column: int) -> tuple[int, int]:
    """Recursive config dump in the reference's layout
    (print_dict_data, kappa.py:130-145); DATA_DICT is skipped as there."""
    for key, value in data.items():
        if key == "DATA_DICT":
            continue
        sheet.cell(row, column, key)
        column += 1
        if isinstance(value, Mapping):
            row, column = _dump_dict(value, sheet, row, column)
            column -= 1
        elif isinstance(value, list):
            row = _dump_list(value, sheet, row, column)
            column -= 1
        else:
            sheet.cell(row, column, value if value is not None else "")
            row += 1
            column -= 1
    return row, column


def _dump_list(data: list, sheet: Sheet, row: int, column: int) -> int:
    for item in data:
        if isinstance(item, Mapping):
            row, column = _dump_dict(item, sheet, row, column)
        elif isinstance(item, list):
            row = _dump_list(item, sheet, row, column)
        else:
            sheet.cell(row, column, item)
            column += 1
    return row + 1


def expo_result(result: list, cfg: Mapping[str, Any], times: list,
                group_num: int) -> str:
    """Append one repeat's result block to the run workbook.

    ``result`` is ``[aa, oa, kappa, per_class_rows]`` from
    :func:`dmfusion_torch.ops.metrics.aa_oa`; ``times`` is
    ``[train_seconds, test_seconds]``; ``group_num`` is the repeat index.
    """
    savepath = cfg["RESULT_excel"]
    col = group_num * 8
    wb = Workbook() if group_num == 0 or not os.path.exists(savepath) \
        else Workbook.load(savepath)
    sheet = wb.active
    sheet.cell(1 + col, 1, "Category")
    sheet.cell(2 + col, 1, "Overall")
    sheet.cell(3 + col, 1, "Correct")
    sheet.cell(4 + col, 1, "Accuracy")
    for i, (overall, correct, acc) in enumerate(result[3]):
        sheet.cell(1 + col, i + 2, i + 1)
        sheet.cell(2 + col, i + 2, overall)
        sheet.cell(3 + col, i + 2, correct)
        sheet.cell(4 + col, i + 2, acc)
    sheet.cell(6 + col, 2, "OA")
    sheet.cell(6 + col, 3, result[1])
    sheet.cell(6 + col, 4, "AA")
    sheet.cell(6 + col, 5, result[0])
    sheet.cell(6 + col, 6, "KAPPA")
    sheet.cell(6 + col, 7, result[2])
    sheet.cell(6 + col, 8, "Train time(s)")
    sheet.cell(6 + col, 9, times[0])
    sheet.cell(6 + col, 10, "Test time(s)")
    sheet.cell(6 + col, 11, times[1])
    if group_num == 0:
        config_sheet = wb.create_sheet("config")
        _dump_dict(cfg, config_sheet, 1, 1)
    wb.save(savepath)
    return savepath


STREAM_NAMES = ("MS", "PAN", "GM", "GP")


def expo_stream_results(results: list, cfg: Mapping[str, Any],
                        group_num: int) -> str:
    """Append the 4 per-stream OA/AA/kappa rows for one repeat to a
    'streams' sheet (reference ``indicator_SCLN`` capability,
    indicators/kappa.py:211-213: each DQTL stream scored independently).

    ``results`` is a list of 4 ``aa_oa`` outputs in STREAM_NAMES order.
    """
    savepath = cfg["RESULT_excel"]
    wb = Workbook.load(savepath) if os.path.exists(savepath) else Workbook()
    try:
        sheet = wb["streams"]
    except KeyError:
        sheet = wb.create_sheet("streams")
    base = group_num * (len(STREAM_NAMES) + 2)
    sheet.cell(base + 1, 1, f"repeat {group_num}")
    sheet.cell(base + 1, 2, "OA")
    sheet.cell(base + 1, 3, "AA")
    sheet.cell(base + 1, 4, "KAPPA")
    for i, (name, res) in enumerate(zip(STREAM_NAMES, results)):
        aa, oa, k, _rows = res
        sheet.cell(base + 2 + i, 1, name)
        sheet.cell(base + 2 + i, 2, oa)
        sheet.cell(base + 2 + i, 3, aa)
        sheet.cell(base + 2 + i, 4, k)
    wb.save(savepath)
    return savepath
