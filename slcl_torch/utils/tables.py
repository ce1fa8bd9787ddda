"""Results tables (counterpart of ``slcl_tpu/utils/tables.py``; reference
utils/convert_excel_df.py intent): evaluation results as Markdown or LaTeX.
The strings equal the JAX package's for the same results."""
from __future__ import annotations

from typing import Dict, Sequence


def results_to_markdown(results: Dict[str, list],
                        class_names: Sequence[str] = ("MYO", "LV", "RV")) -> str:
    rows = ["| class | Dice | HD95 | ASSD |", "|---|---|---|---|"]
    for i, name in enumerate(class_names):
        rows.append(
            f"| {name} | {results['dc'][2*i]:.4f}({results['dc'][2*i+1]:.4f}) "
            f"| {results['hd'][2*i]:.2f}({results['hd'][2*i+1]:.2f}) "
            f"| {results['asd'][2*i]:.2f}({results['asd'][2*i+1]:.2f}) |")
    mean_dc = sum(results["dc"][0::2]) / len(class_names)
    rows.append(f"| **mean** | **{mean_dc:.4f}** | | |")
    return "\n".join(rows)


def results_to_latex(results: Dict[str, list],
                     class_names: Sequence[str] = ("MYO", "LV", "RV")) -> str:
    lines = [r"\begin{tabular}{lccc}", r"\toprule",
             r"class & Dice & HD95 & ASSD \\", r"\midrule"]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name} & {results['dc'][2*i]:.4f} ({results['dc'][2*i+1]:.4f}) "
            f"& {results['hd'][2*i]:.2f} & {results['asd'][2*i]:.2f} \\\\")
    mean_dc = sum(results["dc"][0::2]) / len(class_names)
    lines += [r"\midrule", f"mean & {mean_dc:.4f} & & \\\\",
              r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)
