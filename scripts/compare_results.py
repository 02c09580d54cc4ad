"""Bit-identity audit between two results*.json artifacts.

Used for the round-5 transfer-pipeline changes (double-buffered uploads,
on-device chunk duplication, pipelined g sweep): the claim is that the
statistics are BIT-identical to the committed artifact — only wall time
and device/compile telemetry may differ.  Exits nonzero and prints the first
mismatch otherwise.

Usage: python scripts/compare_results.py results/results.json /tmp/new/results.json
"""

import json
import sys


def main():
    a_path, b_path = sys.argv[1], sys.argv[2]
    a = json.load(open(a_path))
    b = json.load(open(b_path))

    bad = 0
    # Closed audit: key-set asymmetry in EITHER direction is a mismatch
    # (a superset artifact must not pass as "bit-identical").
    if set(a["g_emp"]) != set(b["g_emp"]):
        print(f"g_emp key sets differ: only-a="
              f"{sorted(set(a['g_emp']) - set(b['g_emp']))} only-b="
              f"{sorted(set(b['g_emp']) - set(a['g_emp']))}")
        bad += 1
    for k in a["g_emp"]:
        if a["g_emp"][k] != b["g_emp"].get(k):
            print(f"g_emp[{k}]: {a['g_emp'][k]!r} != "
                  f"{b['g_emp'].get(k)!r}")
            bad += 1
    if set(a["stats"]) != set(b["stats"]):
        print(f"stats case sets differ: {sorted(a['stats'])} vs "
              f"{sorted(b['stats'])}")
        bad += 1
    for case in a["stats"]:
        a_algs = a["stats"][case]
        b_algs = b["stats"].get(case, {})
        if set(a_algs) != set(b_algs):
            print(f"stats[{case}] algorithm sets differ")
            bad += 1
        for alg in a_algs:
            for field in ("mean", "ci"):
                va = a_algs[alg][field]
                vb = b_algs.get(alg, {}).get(field)
                if va != vb:
                    print(f"stats[{case}][{alg}][{field}]:")
                    for i, (x, y) in enumerate(zip(va, vb or [])):
                        if x != y:
                            print(f"  [{i}] {x!r} != {y!r}")
                    bad += 1
    if bad:
        print(f"MISMATCH: {bad} fields differ")
        sys.exit(1)
    print(f"BIT-IDENTICAL: g_emp + all case stats match "
          f"({a_path} vs {b_path}); walls {a.get('wall_s'):.1f}s vs "
          f"{b.get('wall_s'):.1f}s")


if __name__ == "__main__":
    main()
