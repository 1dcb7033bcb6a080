"""Dependency-free minimal .xlsx writer, the port's copy of
``ubpl_tpu/utils/xlsx.py`` (reference CommUtils.xlsx_save,
utils/base/comm.py:105-173, writes conditional-formatted sheets via openpyxl
— a dependency the port does not take, so this emits the OOXML zip
directly).

Scope matches the reference artifact: one sheet of rows, with the best cell
of a chosen column highlighted (solid fill), which is what its conditional
formatting rendered.  Readable by Excel/LibreOffice/openpyxl.
"""
import math
import os
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="report" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
<Relationship Id="rId2" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/styles" Target="styles.xml"/>
</Relationships>"""

# style 1 = bold header; style 2 = highlight fill (reference PatternFill)
_STYLES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<fonts count="2"><font/><font><b/></font></fonts>
<fills count="3"><fill><patternFill patternType="none"/></fill>
<fill><patternFill patternType="gray125"/></fill>
<fill><patternFill patternType="solid"><fgColor rgb="FFFFD966"/></patternFill></fill></fills>
<borders count="1"><border/></borders>
<cellStyleXfs count="1"><xf/></cellStyleXfs>
<cellXfs count="3"><xf/><xf fontId="1" applyFont="1"/>
<xf fillId="2" applyFill="1"/></cellXfs>
</styleSheet>"""


def _col_name(idx):
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


def _cell(r, c, value, style=0):
    ref = f"{_col_name(c)}{r + 1}"
    s = f' s="{style}"' if style else ""
    if isinstance(value, bool):
        value = int(value)
    # NaN/inf are invalid OOXML numerics — emit them as strings instead
    if isinstance(value, (int, float)) and math.isfinite(value):
        return f'<c r="{ref}"{s}><v>{value}</v></c>'
    return (f'<c r="{ref}" t="inlineStr"{s}>'
            f'<is><t>{escape(str(value))}</t></is></c>')


def write_xlsx(path, columns, rows, highlight=None):
    """Write one sheet; `highlight` is an optional (row_idx, col_idx) data
    cell (0-based, excluding the header) to fill — the reference's
    conditional-format-best-cell behavior."""
    sheet_rows = []
    cells = "".join(_cell(0, c, v, style=1) for c, v in enumerate(columns))
    sheet_rows.append(f'<row r="1">{cells}</row>')
    for i, row in enumerate(rows):
        cells = "".join(
            _cell(i + 1, c, v,
                  style=2 if highlight == (i, c) else 0)
            for c, v in enumerate(row))
        sheet_rows.append(f'<row r="{i + 2}">{cells}</row>')
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>'
             + "".join(sheet_rows) + "</sheetData></worksheet>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/styles.xml", _STYLES)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
