"""Label/outcome lookups from clinical spreadsheets.

Counterpart of ``data/accessors.py`` in the JAX package, with the same
lookup semantics and sentinel codes as the reference's DataAccessors
(reference: DataAccessors.py:13-168): -9 = not found / empty cell,
-99 = value present but not convertible to the requested dtype. Sheets are
read as .csv (the stdlib) or .json (a list of rows). The port does not
read Excel files: the machines it runs on need not have pandas, so an
.xlsx/.xls sheet stops the program with a message to convert it to csv.
"""

import csv
import json
import os


def _read_cells(filename):
    """Return the sheet as a list of rows of cell values (strings/numbers)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext in (".xlsx", ".xls"):
        raise SystemExit(
            f"{filename}: Excel sheets are not read by the PyTorch package; "
            "save the sheet as .csv (same rows and columns) and pass that")
    if ext == ".csv":
        with open(filename, newline="") as f:
            return [row for row in csv.reader(f)]
    if ext == ".json":
        with open(filename) as f:
            return json.load(f)
    raise ValueError(f"unsupported table format: {filename}")


def _cell(rows, r, c):
    try:
        return rows[r][c]
    except IndexError:
        return ""


def _lookup(rows, target_row, target_col, dtype):
    """Shared sentinel-coded fetch (reference: DataAccessors.py:31-47)."""
    if not (target_row > -1 and target_col > -1):
        return dtype(-9)
    value = _cell(rows, target_row, target_col)
    if value == "":
        return dtype(-9)
    try:
        return dtype(value)
    except (TypeError, ValueError):
        return dtype(-99)


def split_GHP_convention(idx_base, dtypes):
    """Parse 'GHP_<n>_<biopsy>'-style ids (reference: DataAccessors.py:120-127)."""
    idx_base = str(idx_base).replace("-", "_")
    parts = idx_base.split("_")
    try:
        return dtypes[0](parts[0]), dtypes[1](parts[1]), dtypes[2](parts[2])
    except (IndexError, ValueError):
        return dtypes[0]("-99"), dtypes[1]("-99"), dtypes[2]("-99")


def getClusterIndex(identifiers, outcome_name, filename,
                    dtypes=(str, int, str), dtype=str):
    """Slide id -> cluster designation (A/B/C). Row ids in column 0 are
    matched through split_GHP_convention; the outcome column header lives
    in row 2 (reference: DataAccessors.py:130-168). Empty cell -> -1."""
    rows = _read_cells(filename)
    target_row = target_col = -1
    for r in range(len(rows)):
        if identifiers == split_GHP_convention(_cell(rows, r, 0), dtypes):
            target_row = r
    ncols = max((len(row) for row in rows), default=0)
    for c in range(ncols):
        if _cell(rows, 1, c) == outcome_name:
            target_col = c
    if not (target_row > -1 and target_col > -1):
        return dtype(-9)
    value = _cell(rows, target_row, target_col)
    if value == "":
        return dtype(-1)
    try:
        return dtype(value)
    except (TypeError, ValueError):
        return dtype(-99)


def getOutcome(idx_base, outcome_name, filename, dtype=float):
    """Patient outcome: ids in column 0, headers in row 4
    (reference: DataAccessors.py:13-47)."""
    rows = _read_cells(filename)
    target_row = target_col = -1
    for r in range(min(len(rows), 152)):
        if str(idx_base) in str(_cell(rows, r, 0)):
            target_row = r
    ncols = max((len(row) for row in rows), default=0)
    for c in range(ncols):
        if _cell(rows, 3, c) == outcome_name:
            target_col = c
    return _lookup(rows, target_row, target_col, dtype)


def getGrade(idx_base, outcome_name, filename, dtype=float):
    """Grade lookup: ids in column 1, headers in row 1
    (reference: DataAccessors.py:49-83)."""
    rows = _read_cells(filename)
    target_row = target_col = -1
    for r in range(len(rows)):
        if str(idx_base) in str(_cell(rows, r, 1)):
            target_row = r
    ncols = max((len(row) for row in rows), default=0)
    for c in range(ncols):
        if _cell(rows, 0, c) == outcome_name:
            target_col = c
    return _lookup(rows, target_row, target_col, dtype)


def getMRN(idx_base, outcome_name, filename, dtype=float):
    """MRN lookup: ids in column 1, value in column 0
    (reference: DataAccessors.py:85-117)."""
    rows = _read_cells(filename)
    target_row = -1
    for r in range(len(rows)):
        if str(idx_base) in str(_cell(rows, r, 1)):
            target_row = r
    return _lookup(rows, target_row, 0, dtype)
