"""Results tables: the port's copy of
``multimodal_unlearning_tpu/cli/build_tables.py``, without pandas.

  python -m multimodal_unlearning_tpu_torch.cli.build_tables mode=vllm \\
      base_model=models/llava/ft_full+tofu gold_model=models/llava/ft_retain90+tofu \\
      'methods=[npo, grad_ascent]' out=mm_results

- ``mode=vllm``: per run (the gold and base models, then the first
  ``<base_model>/<method>*`` directory of each method) the mm metrics of
  its ``eval_results/eval_log_aggregated.json`` against the gold model's,
  cached as ``<out>/<run>.json``; then the harmonic means (scipy's
  ``hmean``) of the Real / Retain / Forget metric groups and Model utility,
  Forget Quality = 1 - JS, written as ``<out>/mm_results.json`` and printed as
  a LaTeX table with the papergray marker on rows whose Retain metric is
  under 0.4;
- ``mode=mod``: the same per modality (``<method>*_text``, ``_visual``, both),
  into ``modalities_results.json``.

The JSON file and the table are written by hand in the layout of pandas'
``DataFrame.to_json(indent=4)`` (columns, then rows "0", "1", ...; floats
at 10 decimals as its encoder rounds them) and ``to_latex(index=False,
float_format="%.2f")``, byte for byte.  Host only.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
from scipy.stats import hmean

from multimodal_unlearning_tpu_torch.evaluation import metrics

REAL_METRICS = ["Prob. Real Faces", "Truth Ratio Real Faces", "Prob. Real World",
                "Truth Ratio Real World"]
RETAIN_METRICS = ["Prob. Retain", "Truth Ratio Retain", "Prob. Retain FaceRec",
                  "Truth Ratio Retain FaceRec"]
FORGET_METRICS = ["Prob. Forget", "Truth Ratio Forget", "Prob. Forget FaceRec",
                  "Truth Ratio Forget FaceRec"]
UTIL_METRICS = REAL_METRICS + RETAIN_METRICS

MODALITY_SUFFIXES = {"_text": "text", "_visual": "visual", "": "both"}


def aggregate_one(model_dir: Path, gold_aggregated: dict, method_name: str, res_folder: Path,
                  reeval=False) -> dict:
    """The metrics of one run directory, cached under ``res_folder``."""
    res_file = res_folder / (model_dir.name + ".json")
    if res_file.exists() and not reeval:
        return json.loads(res_file.read_text())
    eval_results = model_dir / "eval_results" / "eval_log_aggregated.json"
    if not eval_results.exists():
        raise FileNotFoundError(f"File {eval_results} not found")
    ckpt = json.loads(eval_results.read_text())
    res = dict(method=method_name, **metrics.compute_model_utility(ckpt),
               **metrics.evaluate_forget_quality(ckpt, gold_aggregated))
    res_folder.mkdir(parents=True, exist_ok=True)
    res_file.write_text(json.dumps(res, indent=4, default=float))
    return res


# ------------------------------------------------------------------ a table
# columns: name -> list of cells (None = missing), in pandas' order: the keys
# of the rows as they first appear


def _table(rows: list[dict]) -> dict:
    names = []
    for r in rows:
        names.extend(k for k in r if k not in names)
    return {k: [r.get(k) for r in rows] for k in names}


def _numeric(col) -> bool:
    return all(v is None or isinstance(v, (int, float, np.number)) and not isinstance(v, bool)
               for v in col)


def _floats(col) -> np.ndarray:
    return np.asarray([np.nan if v is None else float(v) for v in col], np.float64)


def _json_float(v: float) -> str:
    """A float as pandas' JSON encoder writes it at its default precision
    (10 decimals): the fraction truncated to 10 digits and rounded on the
    remainder (a remainder of exactly one half rounds an odd or zero last
    digit up), trailing zeros dropped."""
    if not math.isfinite(v):
        return "null"
    if v == 0:
        return "0.0"
    neg, v = v < 0, abs(v)
    if v >= 1e16:
        return repr(-v if neg else v)
    whole = int(v)
    tmp = (v - whole) * 1e10
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
        if frac >= 10**10:
            frac, whole = 0, whole + 1
    s = f"{whole}." + (str(frac).rjust(10, "0").rstrip("0") if frac else "0")
    return "-" + s if neg else s


def _json_cell(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return _json_float(float(v))
    return json.dumps(str(v)).replace("/", "\\/")


def to_json_text(table: dict) -> str:
    """pandas' ``DataFrame.to_json(indent=4)`` of the table."""
    cols = []
    for name, col in table.items():
        if _numeric(col) and any(v is None or isinstance(v, (float, np.floating))
                                 for v in col):  # a float64 column: ints as floats too
            col = [None if v is None else float(v) for v in col]
        cells = ",\n".join(f'        "{i}":{_json_cell(v)}' for i, v in enumerate(col))
        cols.append(f"    {_json_cell(name)}:{{\n{cells}\n    }}")
    return "{\n" + ",\n".join(cols) + "\n}"


def to_latex_text(table: dict, cols: list[str]) -> str:
    """pandas' ``to_latex(header=True, index=False, float_format="%.2f")`` of
    the table's ``cols``."""
    numeric = [_numeric(table[c]) for c in cols]
    lines = ["\\begin{tabular}{" + "".join("r" if n else "l" for n in numeric) + "}",
             "\\toprule", " & ".join(cols) + " \\\\", "\\midrule"]
    n_rows = len(table[cols[0]]) if cols else 0
    for i in range(n_rows):
        cells = []
        for c, num in zip(cols, numeric):
            v = table[c][i]
            if num:
                x = float("nan") if v is None else float(v)
                cells.append("NaN" if math.isnan(x) else "%.2f" % x)
            else:
                cells.append("NaN" if v is None else str(v))
        lines.append(" & ".join(cells) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return "\n".join(lines)


def build_table(rows: list[dict], out_json: Path) -> dict:
    table = _table(rows)

    def calc(keys):
        present = [k for k in keys if k in table]
        return hmean([_floats(table[k]) for k in present], axis=0)

    table["Real metric"] = calc(REAL_METRICS).tolist()
    table["Forget metric"] = calc(FORGET_METRICS).tolist()
    table["Retain metric"] = calc(RETAIN_METRICS).tolist()
    table["Model utility"] = calc(UTIL_METRICS).tolist()
    table["Forget Quality"] = (1 - _floats(table["JS metric"])).tolist()
    out_json.write_text(to_json_text(table))

    # papergray marker for collapsed-retain rows
    table["Method"] = [("\\rowcolor{papergray} " + m) if r < 0.4 else m
                       for m, r in zip(table["Method"], table["Retain metric"])]
    cols = ["Method", "Real metric", "Retain metric", "Forget metric", "Forget Quality"]
    if "Modality" in table:
        cols.insert(1, "Modality")
    print(to_latex_text(table, cols))
    return table


def main(argv=None):
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    mode = args.get("mode", "vllm")
    base = Path(args["base_model"])
    gold = Path(args["gold_model"])
    res_folder = Path(args.get("out", "mm_results"))
    methods = [m.strip() for m in args.get("methods", "").strip("[]").split(",") if m.strip()]

    gold_aggregated = json.loads((gold / "eval_results" / "eval_log_aggregated.json").read_text())
    rows = []
    for name, run_dir in [("Gold", gold), ("Base", base)]:
        try:
            rows.append({**aggregate_one(run_dir, gold_aggregated, name, res_folder),
                         "Method": name})
        except FileNotFoundError as e:
            print(f"skip {name}: {e}")

    suffixes = MODALITY_SUFFIXES if mode == "mod" else {"": None}
    for m in methods:
        for suffix, modality in suffixes.items():
            run_dir = (next(iter(sorted(base.glob(f"{m}*{suffix}"))), None)
                       if suffix or mode == "vllm" else None)
            run_dir = run_dir or (base / f"{m}_sweep")
            try:
                row = {**aggregate_one(run_dir, gold_aggregated, m, res_folder), "Method": m}
                if modality:
                    row["Modality"] = modality
                rows.append(row)
            except FileNotFoundError as e:
                print(f"skip {m}{suffix}: {e}")

    if not rows:
        print("no results found")
        return None
    return build_table(rows, res_folder / ("modalities_results.json" if mode == "mod"
                                           else "mm_results.json"))


if __name__ == "__main__":
    main()
