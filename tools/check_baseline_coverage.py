#!/usr/bin/env python
"""Audit out/bench_tables.json coverage of every published reference GPU cell.

One row per GPU-column cell of the paper's Tables IV-X / Fig. 5c (the
inventory BASELINE.md mirrors), mapped to its twin in the bench_suite report.
Prints covered / MISSING per cell and a summary; exits nonzero if anything
is missing so the bench queue can gate on it.

Usage: python tools/check_baseline_coverage.py [out/bench_tables.json]
"""
import json
import sys


def cells():
    """(label, path) — path is a list of keys into the report."""
    out = []
    for b in (2, 4, 8, 16, 32):
        out.append((f"Table IV gate batch {b}-bit", ["gate_batch", str(b), "s"]))
        out.append((f"Table IV phase split {b}-bit", ["gate_phases", str(b), "bs_s"]))
    out.append(("Fig 5c compound gate", ["compound_gate", "compound_s"]))
    for b in (16, 24, 32):
        out.append((f"Table V add GPU_1 {b}-bit", ["add", str(b), "bitwise_s"]))
        out.append((f"Table V add GPU_n {b}-bit", ["add", str(b), "numberwise_s"]))
    for L in (4, 8, 16, 32):
        out.append((f"Table VI vec add 16-bit L={L}", ["vector_add", str(L), "s"]))
        out.append((f"Table VI vec add 32-bit L={L}", ["vector_add_32bit", str(L), "s"]))
    for b in (16, 24, 32):
        out.append((f"Table VII mul naive {b}-bit", ["mul", str(b), "naive_s"]))
    for b in (16, 32):  # paper has no 24-bit Karatsuba row
        out.append((f"Table VII mul karatsuba {b}-bit", ["mul", str(b), "karatsuba_s"]))
    for L in (4, 8, 16, 32):
        out.append((f"Table VIII vec mul 16-bit L={L}", ["vector_mul", str(L), "s"]))
        out.append((f"Table VIII vec mul 32-bit L={L}", ["vector_mul_32bit", str(L), "s"]))
    for D in (2, 4, 8, 16):
        out.append((f"Table IX matmul {D}x{D} (tree)", ["matmul", str(D), "tree_s"]))
        out.append((f"Table IX matmul {D}x{D} (Cannon)", ["matmul", str(D), "cannon_s"]))
    out.append(("Table X linreg binary 200x10", ["linreg", "binary", "s"]))
    out.append(("Table X linreg numerical 200x10", ["linreg", "numerical", "s"]))
    out.append(("BASELINE config 4: 64-elem vector add", ["vector64", "add_s"]))
    out.append(("BASELINE config 4: 64-elem vector compare", ["vector64", "compare_s"]))
    return out


def main(path="out/bench_tables.json"):
    with open(path) as f:
        tables = json.load(f)
    missing = 0
    for label, keys in cells():
        node = tables
        for k in keys:
            if isinstance(node, dict):
                node = node.get(k, node.get(k.lstrip("0") if k.isdigit() else k))
                if node is None and k.isdigit():
                    break
            else:
                node = None
                break
        ok = node is not None
        missing += not ok
        print(f"{'covered' if ok else 'MISSING'}  {label}")
    total = len(cells())
    print(f"\n{total - missing}/{total} published GPU cells have a measured twin"
          + (f" — {missing} missing" if missing else ""))
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
