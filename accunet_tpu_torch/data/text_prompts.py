"""Text prompts of the text-conditioned SegMamba variants: counterpart of
accunet_tpu/data/text_prompts.py (`read_text`).

`read_text(folder)` takes the first `.xlsx` or `.csv` file of the dataset
folder (sorted by name) and returns {image file name: prompt} from the
first column pair it has of ("Filename", "Text"), ("image_name",
"prompt_text"), ("Image", "Description"), both stripped, a `.jpg` name
written as `.png`; None without such a file. A `.csv` is read with the
standard library as pandas reads it in JAX: blank lines skipped, an empty
cell or one of pandas' missing-value words becomes "nan" (pandas'
`str(NaN)`). An `.xlsx` needs pandas (and its Excel reader).
"""

from __future__ import annotations

import csv
import os

_COLUMN_PAIRS = [
    ("Filename", "Text"),
    ("image_name", "prompt_text"),
    ("Image", "Description"),
]

# pandas.read_csv's default missing-value strings
_NA_VALUES = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
              "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _csv_rows(path: str) -> tuple[list[str], list[dict[str, str]]]:
    with open(path, newline="", encoding="utf-8-sig") as f:
        lines = [row for row in csv.reader(f) if row]
    columns, rows = lines[0], []
    for line in lines[1:]:
        cells = line + [""] * (len(columns) - len(line))
        rows.append({c: "nan" if v in _NA_VALUES else v for c, v in zip(columns, cells)})
    return columns, rows


def _xlsx_rows(path: str) -> tuple[list[str], list[dict[str, str]]]:
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"reading the prompt file {path} needs pandas") from e
    df = pd.read_excel(path)
    return list(df.columns), [{c: str(v) for c, v in row.items()} for _, row in df.iterrows()]


def read_text(folder_path: str) -> dict[str, str] | None:
    files = [f for f in sorted(os.listdir(folder_path)) if f.endswith((".xlsx", ".csv"))]
    if not files:
        return None
    path = os.path.join(folder_path, files[0])
    columns, rows = _xlsx_rows(path) if path.endswith(".xlsx") else _csv_rows(path)
    for fcol, tcol in _COLUMN_PAIRS:
        if fcol in columns and tcol in columns:
            break
    else:
        raise ValueError(f"text file {path} lacks expected columns; found {columns}")
    out = {}
    for row in rows:
        fname = row[fcol].strip()
        if not fname.endswith(".png"):
            fname = fname.replace(".jpg", ".png")
        out[fname] = row[tcol].strip()
    return out
