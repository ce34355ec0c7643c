"""A minimal .xlsx writer with the standard library only (counterpart of
``fullsubnet_tpu/xlsx.py``).

An .xlsx file is a zip of a few XML parts (OOXML SpreadsheetML,
ECMA-376), written here directly: strings as inline strings (no
shared-string table), numbers as numeric cells. That is all a metric table
needs, and Excel, LibreOffice, pandas/openpyxl and Google Sheets read it.
"""

from __future__ import annotations

import math
import numbers
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    """0-based column index -> A, B, ..., Z, AA, ..."""
    name = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell(ref: str, value) -> str:
    if isinstance(value, bool):  # bool is an int subclass: check first
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    # numbers.* covers numpy scalars too. SpreadsheetML <v> holds a decimal
    # literal: numpy scalars repr as np.float64(...) and NaN/inf are
    # invalid, so format explicitly; a non-finite value becomes a string
    # cell. Integral first: huge ints overflow float().
    if isinstance(value, numbers.Integral):
        return f'<c r="{ref}"><v>{int(value)}</v></c>'
    if isinstance(value, numbers.Real):
        f = float(value)
        if math.isfinite(f):
            return f'<c r="{ref}"><v>{format(f, ".17g")}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'


def write_xlsx(path, rows, headers=None, sheet_name="Sheet1"):
    """Write ``rows`` (iterable of cell sequences) as a one-sheet workbook.

    ``headers`` (optional) becomes the first row. Numeric cells stay
    numeric; everything else is stringified.
    """
    all_rows = ([list(headers)] if headers is not None else []) + [
        list(r) for r in rows
    ]
    body = []
    for ri, row in enumerate(all_rows, start=1):
        cells = "".join(
            _cell(f"{_col_name(ci)}{ri}", v) for ci, v in enumerate(row)
        )
        body.append(f'<row r="{ri}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main">'
        f"<sheetData>{''.join(body)}</sheetData></worksheet>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK.format(name=escape(sheet_name)))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
